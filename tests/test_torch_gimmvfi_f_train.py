"""Stage-2 GIMM-VFI-F training of the port against the JAX package, on the CPU.

One `make_gimmvfi_train_step` of GIMMVFI_F(ff_iters=2) at 128x128, batch
2 (the JAX package's F step, `tests/test_train_step.py:224`), from a seeded
port model whose state dict goes into JAX through `convert_gimmvfi_f`, on
one seeded batch, SGD after a gradient-keeping pass: the loss and each term
<= 1e-5 relative, the parameters after the update <= 1e-6 max-abs, each
gradient tensor, in relative L2 norm, within 4x of JAX's own float32 noise
in it (the gap to JAX's gradient of the same step with the batch's two
samples swapped; ROADMAP C3, as `test_torch_gimmvfi_train.py`, where the
alphas are held; the biases whose gradient is zero in exact arithmetic
within 1e-2 x max|g| of their weights; exactly zero where JAX's is),
parameters of both the AMT and the flow
estimator's groups moved, and the decoder heads' running statistics after
the step <= 1e-5 x max(1, max|ref|). FlowFormer has no batch statistics:
`train` changes nothing in it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gimmvfi_tpu.models.gimmvfi_f import GIMMVFI_F as JaxGIMMVFI_F
from gimmvfi_tpu.train import create_optimizer as jax_create_optimizer
from gimmvfi_tpu.train import create_train_state as jax_create_train_state
from gimmvfi_tpu.train.train_state import make_gimmvfi_train_step as jax_make_train_step
from gimmvfi_tpu.utils.convert import convert_gimmvfi_f
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import create_train_state, make_gimmvfi_train_step
from gimmvfi_tpu_torch.utils.convert import jax_gimmvfi_f_params_to_torch

torch.set_num_threads(1)
N, HW = 2, 128
K = int(HW * HW * 0.1)
SGD_LR = 1e-3
REC_WEIGHT = 0.1
TERMS = ("loss_total", "lap", "census", "l1", "rec", "lpips", "psnr")
ALPHAS = ("alpha_v", "alpha_fe")
NOISE_FACTOR = 4.0  # the largest gap / noise read is 1.41 (ROADMAP C3)
# zero in exact arithmetic: the decoder heads' 1x1 projection biases (a
# batch-statistics BN follows) and the attention key biases (the softmax over
# keys drops a constant added to every logit of a query)
ZERO_GRAD_BIAS = re.compile(r"amt_init_decoder\.upsample\.6\.bias|amt_final_decoder\.upsample\.7\.bias"
                            r"|.*\.k\.bias")


def _keep_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def test_f_train_step_matches_jax():
    torch.manual_seed(2)
    m = GIMMVFI_F(ff_iters=2, device="cpu")
    params, stats = convert_gimmvfi_f({k: v.numpy() for k, v in m.state_dict().items()})
    rng = np.random.default_rng(6)
    batch = {"img0": rng.random((N, HW, HW, 3), dtype=np.float32),
             "img1": rng.random((N, HW, HW, 3), dtype=np.float32),
             "gt": rng.random((N, HW, HW, 3), dtype=np.float32),
             "t": np.asarray([0.5, 0.25], np.float32),
             "sub_idx0": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32),
             "sub_idx1": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32)}

    model = JaxGIMMVFI_F(ff_iters=2, remat=False)
    tx = optax.chain(_keep_grads(), jax_create_optimizer(
        params, opt_type="sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False))
    step = jax.jit(jax_make_train_step(model, tx, rec_weight=REC_WEIGHT, use_ema=False))
    state = jax_create_train_state({"params": params, "batch_stats": stats}, tx, use_ema=False)
    new_state, ref = jax.tree_util.tree_map(np.asarray, step(state, batch))
    # the same step with the two samples swapped: equal in exact arithmetic,
    # its gradients differ from the first's by JAX's float32 rounding alone
    swapped_state, _ = step(state, {k: v[::-1].copy() for k, v in batch.items()})

    opt, sched = create_optimizer(m, "sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False)
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    got = make_gimmvfi_train_step(REC_WEIGHT, None, use_ema=False)(
        create_train_state(m, opt, sched, use_ema=False), batch)
    for k in TERMS:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k])), (k, got[k], ref[k])

    ref_grads = jax_gimmvfi_f_params_to_torch(new_state.opt_state[0], new_state.batch_stats)
    noise_grads = jax_gimmvfi_f_params_to_torch(
        jax.tree_util.tree_map(np.asarray, swapped_state.opt_state[0]), new_state.batch_stats)
    ref_sd = jax_gimmvfi_f_params_to_torch(new_state.params, new_state.batch_stats)
    rel_l2 = lambda got, want: float((got - want).double().norm() / want.double().norm())
    within, worst, named = 0, (0.0, None, 0.0), dict(m.named_parameters())
    for name, p in named.items():
        g_ref = ref_grads[name]
        within += float((p.grad - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())
        if name in ALPHAS:
            continue  # near-cancelling sums: held in test_torch_gimmvfi_train.py
        if ZERO_GRAD_BIAS.fullmatch(name):
            w_scale = float(ref_grads[name[:-len("bias")] + "weight"].abs().max())
            assert all(float(g.abs().max()) <= 1e-2 * w_scale for g in (p.grad, g_ref)), name
        elif float(g_ref.abs().max()) == 0:
            # a weight that no path of the step reaches in JAX
            assert float(p.grad.abs().max()) == 0, name
        else:
            gap, noise = rel_l2(p.grad, g_ref), rel_l2(noise_grads[name], g_ref)
            assert gap <= NOISE_FACTOR * noise, (name, gap, noise)
            worst = max(worst, (gap / noise, name, gap))
        assert float((p.detach() - ref_sd[name]).abs().max()) <= 1e-6, name
    print(f"F stage-2 step vs JAX: {within} of {len(named)} gradient tensors within "
          f"1e-4 x max|g|; largest relative L2 gap / JAX's noise {worst[0]:.3f} ({worst[1]}, "
          f"gap {worst[2]:.3e})")
    moved = {n: float((p.detach() - before[n]).abs().max()) for n, p in m.named_parameters()}
    assert max(v for n, v in moved.items() if n.startswith("amt_final_decoder")) > 0
    assert max(v for n, v in moved.items() if n.startswith("flow_estimator")) > 0
    for k, v in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            bound = 1e-5 * max(1.0, float(ref_sd[k].abs().max()))
            assert float((v - ref_sd[k]).abs().max()) <= bound, k
