"""FLOP counts and the kernels' bound arithmetic against the copies'
originals in chip_smoke.py."""
import numpy as np
import pytest
import torch

from portbench import manifest, roofline
from portbench.families import bst, dlrm, flops_per_example

DLRM = manifest.cell("dlrm_kaggle.b65536")
BST_LONG = manifest.cell("bst_taobao.T1000_b1024")
BST_SHORT = manifest.cell("bst_taobao.T100_b1024")


def test_dlrm_forward_macs():
    macs = dlrm.forward_macs(DLRM.config["model"], {})
    # bottom 13-512-256-64-16: 155,136; the 351 pairs of 27 features of 16: 5,616;
    # top on the source's 351 + 16 = 367 inputs, 367-512-256-1: 319,232
    assert macs == {"bf16": 155_136 + 319_232, "f32": 5_616}
    assert sum(macs.values()) == 479_984
    flops = flops_per_example(dlrm, DLRM.config["model"], [{}, {}])
    assert sum(flops.values()) == 6 * 479_984  # ~2.88 MFLOP, backward twice the forward


def _history(lengths, T):
    his = np.zeros((len(lengths), T), np.int32)
    for i, n in enumerate(lengths):
        his[i, :n] = 7
    return {"pos_his_item": his}


@pytest.mark.parametrize("cell, T", [(BST_SHORT, 100), (BST_LONG, 1000)])
def test_bst_forward_macs_count_valid_positions(cell, T):
    model = cell.config["model"]
    lengths = [T // 2, T, T - 3]
    macs = bst.forward_macs(model, _history(lengths, T))
    # one block, d_model 64 + 64: qkv 128 x 384, out 128 x 128, FFN 128 x 512 twice a
    # valid position; 8 heads of 16: valid x valid scores and weighted values
    rows = [(n + 1) * (128 * 384 + 128 * 128 + 2 * 128 * 512) + 2 * 8 * (n + 1) ** 2 * 16
            for n in lengths]
    assert macs["f32"] == pytest.approx(sum(rows) / 3, rel=1e-12)
    # the head: [target output, history mean] 256-1024-512-256-1 in bf16
    assert macs["bf16"] == 256 * 1024 + 1024 * 512 + 512 * 256 + 256 == 917_760
    # pads add no model work
    padded = bst.forward_macs(model, _history([T // 2], T + 50))
    assert padded == bst.forward_macs(model, _history([T // 2], T // 2))


def test_k1_bytes_match_chip_smoke():
    import chip_smoke

    for n, dim, ub, vocab in ((212_992, 16, 2, 1_000_000), (102_400, 18, 4, 400_000)):
        # chip_smoke._k1_case: ids, order, updates read once; the f32 table written once
        want = n * 4 * 2 + n * dim * ub + vocab * dim * 4
        assert chip_smoke.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
        # with every row of the table touched, K1's kernels write it all
        assert roofline.k1_kernel_bytes(n, vocab, dim, ub) == want
        assert roofline.k1_bound_s(n, 1000, dim, ub) == pytest.approx(
            (want - (vocab - 1000) * dim * 4) / chip_smoke.HBM_BYTES_PER_S)


@pytest.mark.parametrize("B, L, H, Dh", [(1024, 101, 4, 9), (128, 1001, 4, 9)])
def test_k2_bounds_match_chip_smoke(B, L, H, Dh):
    import chip_smoke

    rng = np.random.default_rng(B + L)
    lengths = rng.integers(L // 2, L, size=B)
    valid = np.arange(L)[None, :] < lengths[:, None]
    valid[:, -1] = True
    ours = roofline.k2_bounds(roofline.k2_work(valid, H, Dh), Dh)
    theirs = chip_smoke.k2_bounds(chip_smoke.k2_work(torch.from_numpy(valid), H, Dh), Dh)
    for k in ("fwd", "bwd"):
        for field in ("bytes", "flops", "bound_ms", "bound_by"):
            assert ours[k][field] == pytest.approx(theirs[k][field]) if field != "bound_by" \
                else ours[k][field] == theirs[k][field]
    assert chip_smoke.TF32_FLOPS == roofline.TF32_FLOPS


def test_k_calls_at_the_cells_shapes():
    ctr = DLRM.generator.pool(DLRM.traffic, DLRM.config["model"], 3, 1)[0]
    (call,) = dlrm.k1_calls(DLRM.config["model"], ctr)
    assert call == dict(n=DLRM.traffic["batch"] * 26, unique=len(np.unique(ctr["cat_features"])),
                        dim=16, update_bytes=4, order=True)
    assert 1000 < call["unique"] < call["n"]
    batch = BST_SHORT.generator.pool(BST_SHORT.traffic, BST_SHORT.config["model"], 3, 1)[0]
    calls = bst.k1_calls(BST_SHORT.config["model"], batch)
    assert sorted(c["n"] for c in calls) == [1024, 1024, 102_400, 102_400]
    assert all(c["unique"] <= c["n"] and c["dim"] == 64 for c in calls)
    k2 = bst.k2_calls(BST_SHORT.config["model"], batch)
    assert len(k2) == 1 and k2[0][0].shape == (1024, 101) and k2[0][1:] == (8, 16)
    assert k2[0][0][:, -1].all()


def test_mfu_peaks_price_precisions_apart():
    assert roofline.F32_ACCURATE_FLOPS == pytest.approx(165e12)
    t = roofline.peak_time_s({"f32": 165e12, "bf16": 989e12})
    assert t == pytest.approx(2.0)
