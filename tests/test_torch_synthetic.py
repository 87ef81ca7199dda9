"""The port's host data code against the JAX package's, and its import
boundary: the port must load where jax is not installed."""
import os
import subprocess
import sys

import pytest

from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticCTR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize(
    "vocab,gen_seed,sample_seed,n",
    [(1000, 0, 1, 512), (100_000, 3, 7, 300), (50, 1, 2, 64)],
)
def test_synthetic_ctr_bit_identical(vocab, gen_seed, sample_seed, n):
    ours = SyntheticCTR(vocab_size=vocab, seed=gen_seed).sample(n, sample_seed)
    ref = JaxSyntheticCTR(vocab_size=vocab, seed=gen_seed).sample(n, sample_seed)
    _assert_same(ours, ref)


@pytest.mark.parametrize(
    "kw",
    [
        dict(batch_size=32),
        dict(batch_size=30, shuffle=False, drop_remainder=False),
        dict(batch_size=32, seed=5, epochs=3, start_batch=4),
        dict(batch_size=25, epochs=None, start_batch=9),
    ],
)
def test_batch_iterator_bit_identical(kw):
    data = SyntheticCTR(vocab_size=500, seed=0).sample(100, 1)
    ours = batch_iterator(data, **kw)
    ref = jax_batch_iterator(data, **kw)
    n = 0
    for a, b in zip(ours, ref):
        _assert_same(a, b)
        n += 1
        if n >= 12:
            break
    assert n > 0
    if kw.get("epochs", 1) is not None:
        assert next(ours, None) is None and next(ref, None) is None


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import recommender_tpu_torch, recommender_tpu_torch.convert\n"
        "import recommender_tpu_torch.core.train, recommender_tpu_torch.core.metrics\n"
        "import recommender_tpu_torch.core.optim, recommender_tpu_torch.data\n"
        "import recommender_tpu_torch.models, recommender_tpu_torch.nn\n"
        "import recommender_tpu_torch.ops, recommender_tpu_torch.embedding\n"
        "import recommender_tpu_torch.cli.train_dien, recommender_tpu_torch.data.amazon\n"
        "import recommender_tpu_torch.core.tensorboard\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'recommender_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
