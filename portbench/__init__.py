"""The benchmark of ``recommender_tpu_torch`` on NVIDIA GPUs.

One command runs one cell once, from the root of a checkout::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line (``portbench.run``). ``BENCHMARK.json`` at the
root names the cells, configurations and metrics; everything that belongs
to one of them sits in a file of its own here, found by its name:

* ``configs/<config>.json``: a model configuration (``family``, the port's
  class and its arguments, training settings, dtypes, ``reduced``,
  ``assumed``);
* ``families/<family>.py``: builds the port's model and loss for a
  configuration, lists its parameters and their initialisation, counts its
  FLOPs an example and the kernel calls a step; ``reference/<family>.py``
  is the plain PyTorch loss and gradients that decide ``correct`` (it
  imports nothing of the port);
* ``traffic/<traffic>.json``: a traffic mix, read by the generator its
  ``generator`` key names (``generators/<generator>.py``);
* ``checks/<cell>.json``: the limits of the numbers compared with the
  reference in that cell, and the readings they were set from
  (``portbench.calibrate``, then ``portbench.limits``);
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(r)`` over a traced run's readings (``portbench.harness.Readings``)
  that returns a number or None.

A new cell is a ``workloads`` entry and, where it needs them, new files of
the kinds above; no file here needs an edit. The yardstick (the traffic
generators, ``roofline``'s peaks and bound arithmetic, ``trace``'s
reduction of a profiler trace, the references and ``check``'s comparison)
lives here, where a change to the port cannot move it. The only module of
the JAX package's tree the harness could reach is never imported: the
harness refuses to print a result if ``jax``, ``jaxlib``, ``flax`` or
``recommender_tpu`` is loaded (``portbench.run``).
"""
