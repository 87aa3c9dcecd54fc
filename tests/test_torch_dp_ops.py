"""The port's data-parallel collectives (`parallel/dist.py`) on two gloo
ranks of this machine (`spawn_ranks`, a file rendezvous under tmp_path),
on the CPU.

  * `all_reduce_sum`: the sum on every rank, and its backward all-reduces
    the gradient (rank r's loss weighs the sum by r + 2, so every rank's
    input gets 2 + 3);
  * `average_gradients_`: the mean over the ranks; a gradient missing on
    one rank counts as zeros there, one missing on every rank stays None;
  * `global_mean` of a metric dict;
  * `BatchNorm2d(train=True)` on two ranks at batch 1 against one process
    at batch 2: the output, the moved running statistics and (after
    `average_gradients_`) the weight's and bias's gradients to float32
    rounding; each rank's input gradient is 2x the one-process gradient
    of its rows, the gradient of the ranks' summed losses that data
    parallelism averages;
  * after the step every rank's tensors are bitwise the same;
  * the same BatchNorm as a remat unit (`nn/layers.py: remat_call`): the
    backward recomputes it, all-reducing its sums again on both ranks, and
    every reading is bitwise the plain one's on that rank, the running
    statistics included (moved once, against one process without remat).
Without a group every helper is the identity and BatchNorm computes what
it did before data parallelism, bit for bit; `init` refuses a topology
that is not one of equal nodes, and `spawn_ranks` raises when a rank fails.
"""

import os

import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.nn.layers import BatchNorm2d, remat_call
from gimmvfi_tpu_torch.parallel import dist as dist_ops

torch.set_num_threads(1)
WORLD = 2
C, HW = 5, 6


def _bn_inputs():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((WORLD, C, HW, HW)) * 2 + 1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((WORLD, C, HW, HW)).astype(np.float32))
    return x, g


def _bn():
    bn = BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, C))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    return bn


def _ops_worker(out_dir):
    torch.set_num_threads(1)
    r = dist_ops.rank()
    res = {"world": dist_ops.world_size()}
    x = (torch.arange(4.0) * (r + 1)).requires_grad_(True)
    y = dist_ops.all_reduce_sum(x)
    ((r + 2.0) * y).sum().backward()
    res["sum"], res["sum_grad"] = y.detach(), x.grad

    a, b, c = (torch.nn.Parameter(torch.zeros(3)) for _ in range(3))
    a.grad = torch.full((3,), float(r))
    b.grad = torch.tensor([2.0, 4.0, 6.0]) if r == 0 else None
    dist_ops.average_gradients_([a, b, c])
    res["a"], res["b"], res["c_is_none"] = a.grad, b.grad, c.grad is None
    res["mean"] = dist_ops.global_mean({"m": torch.tensor(float(r)), "n": torch.tensor(2.0)})

    xs, gs = _bn_inputs()
    for key, remat in (("bn", False), ("bn_remat", True)):
        bn = _bn()
        xr = xs[r:r + 1].clone().requires_grad_(True)
        out = remat_call(bn, xr, True, remat=remat)
        (out * gs[r:r + 1]).mean().backward()
        dist_ops.average_gradients_(bn.parameters())
        res[key] = {"out": out.detach(), "x_grad": xr.grad, "weight_grad": bn.weight.grad,
                    "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                    "running_var": bn.running_var.clone()}
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_ops")
    dist_ops.spawn_ranks(_ops_worker, WORLD, (str(out),), rendezvous=str(out / "rendezvous"))
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


def test_all_reduce_sum_and_its_backward(ranks):
    for res in ranks:
        assert res["world"] == WORLD
        assert torch.equal(res["sum"], torch.arange(4.0) * 3)
        assert torch.equal(res["sum_grad"], torch.full((4,), 5.0))


def test_average_gradients_and_global_mean(ranks):
    for res in ranks:
        assert torch.equal(res["a"], torch.full((3,), 0.5))
        assert torch.equal(res["b"], torch.tensor([1.0, 2.0, 3.0]))
        assert res["c_is_none"]
        assert float(res["mean"]["m"]) == 0.5 and float(res["mean"]["n"]) == 2.0


def test_batchnorm_across_ranks_is_the_global_batch(ranks):
    _check_batchnorm_across_ranks(ranks, "bn")


def test_batchnorm_across_ranks_with_remat_moves_statistics_once(ranks):
    _check_batchnorm_across_ranks(ranks, "bn_remat")
    for res in ranks:
        for k, v in res["bn"].items():
            assert torch.equal(res["bn_remat"][k], v), k


def _check_batchnorm_across_ranks(ranks, key):
    """The ranks' `key` readings against one process at batch 2, without
    remat."""
    xs, gs = _bn_inputs()
    bn = _bn()
    x = xs.clone().requires_grad_(True)
    out = bn(x, train=True)
    (out * gs).mean().backward()
    close = lambda a, b: torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    for r, res in enumerate(ranks):
        got = res[key]
        assert close(got["out"], out[r:r + 1].detach())
        assert close(got["x_grad"], WORLD * x.grad[r:r + 1])
        assert close(got["weight_grad"], bn.weight.grad) and close(got["bias_grad"], bn.bias.grad)
        assert close(got["running_mean"], bn.running_mean)
        assert close(got["running_var"], bn.running_var)
    # the global statistics moved the running ones, not a rank's own
    own = _bn()
    own(xs[:1], train=True)
    assert not close(ranks[0][key]["running_var"], own.running_var)
    for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        assert torch.equal(ranks[0][key][k], ranks[1][key][k]), k


def test_without_a_group_nothing_changes():
    assert not dist_ops.group_up() and dist_ops.world_size() == 1 and dist_ops.rank() == 0
    x = torch.randn(3)
    assert dist_ops.all_reduce_sum(x) is x
    m = {"loss": torch.tensor(1.5)}
    assert dist_ops.global_mean(m) is m
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([1.0, 2.0])
    dist_ops.average_gradients_([p])
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0]))
    # BatchNorm's one-process statistics, bit for bit
    xs, _ = _bn_inputs()
    bn = _bn()
    out = bn(xs, train=True)
    mean = xs.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    want = (xs - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    assert torch.equal(out, want)
    assert torch.equal(bn.running_var, 0.9 * torch.full((C,), 2.0) + 0.1 * var)


@pytest.mark.parametrize("env,match", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
      "GROUP_RANK": "1"}, "GROUP_RANK"),
    ({"RANK": "1", "WORLD_SIZE": "3", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "equal nodes"),
])
def test_init_refuses_a_bad_topology(env, match, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist_ops.launched()
    with pytest.raises(ValueError, match=match):
        dist_ops.init("cpu")
    assert not dist_ops.group_up()


def _fail_on_rank_1():
    if dist_ops.rank() == 1:
        raise RuntimeError("rank 1 fails")


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        dist_ops.spawn_ranks(_fail_on_rank_1, WORLD, rendezvous=str(tmp_path / "rendezvous"))
