"""Model families, one module per family, found by a configuration's
``family`` key. A family module has:

* ``KERNELS``: the port's kernel libraries its step runs, built during
  set-up so that their first build is timed apart;
* ``leaves(model) -> list[weights.Leaf]``: every parameter, named as the
  port's ``named_parameters()`` names it, with its initialisation;
* ``build(model, device) -> (nn.Module, loss_fn)``: the port's model and
  the ``models.tasks`` loss of the Trainer's protocol;
* ``forward_macs(model, batch) -> {"f32": n, "bf16": m}``: the model's
  multiply-adds of one example's forward pass on that batch (its mean
  over the rows), by the precision of their products, without the work
  the port adds (``flops_per_example`` counts the backward at twice the
  forward, with no recomputation);
* ``k1_calls(model, batch)``: K1's calls in a step on that batch, each a
  dict of ``roofline.k1_kernel_bytes``'s arguments;
* ``k2_calls(model, batch)``: K2's calls in a step, each ``(valid [B, L],
  heads, head_dim)``;
* ``FAULTS``: the names of the faults that apply to its cells, shared ones
  (``portbench.faults``) and its own; ``OWN_FAULTS`` (optional): its own,
  by name, as ``portbench.faults`` describes;
* ``TINY``: its CPU test sizes, ``(model overrides, traffic overrides)``
  (``portbench.tests.tiny``);
* ``LAYERS`` (optional): layers of its step beyond the port's shared
  kernels' (``portbench.trace.Layer``: by kernel names or prefixes, or by
  the port span its kernels are launched in).

So a new family is files alone: its module here and its reference in
``portbench/reference/``.
"""


def flops_per_example(family, model: dict, batches: list) -> dict:
    """Over ``batches``, by precision."""
    macs = [family.forward_macs(model, b) for b in batches]
    return {p: 6 * sum(m[p] for m in macs) / len(macs) for p in macs[0]}
