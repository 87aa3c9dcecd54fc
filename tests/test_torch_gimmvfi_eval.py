"""Stage-2 validation of the port against the JAX package, on the CPU.

GIMMVFI_R(raft_iters=2) at 128x128, batch 2, from a seeded port model whose
state dict goes into JAX through `convert_gimmvfi_r` (no JAX init here):
  * `make_gimmvfi_eval_step` against JAX's (running statistics, the
    batched bidirectional flow): each metric <= 1e-5 relative;
  * after a training step, which moves the BatchNorm running statistics,
    `interpolate` still takes the running ones: it equals, bit for bit, a
    fresh model's loaded with the same state dict, and a sample alone
    gives the frame it gives inside the batch;
  * `predict_flow`, at per-sample t and on a subsample, against JAX's.
"""

import jax
import numpy as np
import torch

from gimmvfi_tpu.models.gimmvfi_r import GIMMVFI_R as JaxGIMMVFI_R
from gimmvfi_tpu.train.train_state import make_gimmvfi_eval_step as jax_make_eval_step
from gimmvfi_tpu.utils.convert import convert_gimmvfi_r
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.ops.coords import sample_coords_3d_per_sample
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import (
    create_train_state,
    make_gimmvfi_eval_step,
    make_gimmvfi_train_step,
)

torch.set_num_threads(1)
N, HW = 2, 128
K = int(HW * HW * 0.1)
REC_WEIGHT = 0.1


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"img0": rng.random((N, HW, HW, 3), dtype=np.float32),
            "img1": rng.random((N, HW, HW, 3), dtype=np.float32),
            "gt": rng.random((N, HW, HW, 3), dtype=np.float32),
            "t": np.asarray([1 / 6, 5 / 6], np.float32),
            "sub_idx0": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32),
            "sub_idx1": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32)}


def _seeded_model() -> GIMMVFI_R:
    torch.manual_seed(3)
    return GIMMVFI_R(raft_iters=2, device="cpu")


def test_eval_step_matches_jax():
    m = _seeded_model()
    # non-trivial running statistics, so that the eval step reads them
    with torch.no_grad():
        gen = torch.Generator().manual_seed(4)
        for name, buf in m.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1.0 + 0.5 * torch.rand(buf.shape, generator=gen))
    params, stats = convert_gimmvfi_r({k: v.numpy() for k, v in m.state_dict().items()})
    b = _batch(3)
    ref = jax.jit(jax_make_eval_step(JaxGIMMVFI_R(raft_iters=2, remat=False), REC_WEIGHT))(
        params, stats, b)
    got = make_gimmvfi_eval_step(REC_WEIGHT)(m, b)
    assert sorted(got) == sorted(ref) == ["loss_total", "psnr", "rec"]
    for k in got:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k])), (k, got[k], ref[k])


def test_interpolate_after_a_step_uses_running_statistics():
    m = _seeded_model()
    before = {k: v.clone() for k, v in m.state_dict().items() if k.endswith("running_var")}
    opt, sched = create_optimizer(m, "adamw", init_lr=8e-5, weight_decay=4e-5, ft=True)
    make_gimmvfi_train_step(REC_WEIGHT, None, use_ema=False)(
        create_train_state(m, opt, sched, use_ema=False), _batch(4))
    assert all(not torch.equal(m.state_dict()[k], v) for k, v in before.items())
    fresh = GIMMVFI_R(raft_iters=2, device="cpu")
    fresh.load_state_dict(m.state_dict())
    img = torch.from_numpy(np.stack([_batch(5)["img0"], _batch(5)["img1"]], axis=1))
    got = m.interpolate(img, [0.5])["imgt_pred"][0]
    assert torch.equal(got, fresh.interpolate(img, [0.5])["imgt_pred"][0])
    single = m.interpolate(img[:1], [0.5])["imgt_pred"][0]
    assert float((single - got[:1]).abs().max()) <= 1e-5


def test_predict_flow_matches_jax():
    """`predict_flow` (the GIMM decode of `train_forward`) on seeded flows,
    at a per-sample t on every pixel and at t = 0 on a subsample, against
    JAX's: <= 1e-4 x max|ref|."""
    m = _seeded_model()
    params, stats = convert_gimmvfi_r({k: v.numpy() for k, v in m.state_dict().items()})
    rng = np.random.default_rng(7)
    flows = (rng.standard_normal((N, 2, 64, 80, 2)) * 3).astype(np.float32)  # JAX layout
    scale = np.abs(flows).reshape(N, -1).max(axis=1).reshape(N, 1, 1, 1, 1)
    nflows = (np.stack([flows[:, 0], -flows[:, 1]], axis=1) / scale + 1) / 2
    t = np.asarray([0.25, 0.6], np.float32)
    sub = np.stack([rng.permutation(64 * 80)[:300] for _ in range(N)]).astype(np.int32)
    jm = JaxGIMMVFI_R(raft_iters=2, remat=False)
    for tt, sub_idx in ((t, None), (np.zeros(N, np.float32), sub)):
        coord = sample_coords_3d_per_sample(torch.from_numpy(tt), (64, 80))
        ref = np.asarray(jax.jit(lambda v, nf, f, ts, c, s: jm.apply(
            v, nf, f, ts, c, sub_idx=s, method=jm.predict_flow))(
            {"params": params, "batch_stats": stats}, nflows, flows, tt, coord.numpy(), sub_idx))
        with torch.no_grad():
            got = m.predict_flow(torch.from_numpy(nflows).permute(0, 1, 4, 2, 3),
                                 torch.from_numpy(flows).permute(0, 1, 4, 2, 3),
                                 torch.from_numpy(tt), coord,
                                 None if sub_idx is None else torch.from_numpy(sub_idx))
        assert got.shape == ref.shape == ((N, 1, 64, 80, 2) if sub_idx is None else (N, 300, 2))
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
