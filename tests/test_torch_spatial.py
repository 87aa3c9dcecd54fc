"""The port's spatial sharding (`parallel/spatial.py`) against one process
and against JAX's `interpolate_spatial_sharded`, on the CPU, float32.

One JAX `model.init` of GIMMVFI_R(raft_iters=2) gives the weights
(`utils/convert.py: load_jax_params`).
  (i) In one process: the per-timestep stages over 2 and 3 uneven strips,
      each on its window (`halos`), stitched, against `decode_one`, <= 1e-5
      max-abs, with DS None at 128x256 and DS 0.5 at 256x256; the flow
      scaler is raised so that the decoded flows reach 20 px and cross
      the strip edges.
 (ii) Halos of 0 miss the same check by more than 1e-3.
(iii) Two gloo ranks (`spawn_ranks`) through `interpolate_spatial_sharded`
      against the port's `interpolate_sequential`, <= 1e-5, and against
      JAX's `interpolate_spatial_sharded` on a 2-device virtual mesh, within
      the JAX test's atol 2e-5, rtol 1e-4 and >= 60 dB. Rank 1 builds its
      model from another seed: the entry's broadcast gives it rank 0's.
 (iv) Three ranks at W = 128: padded to 144 as JAX pads (lcm(3, 8) = 24),
      cropped back to 128, against the port on the padded pair and against
      JAX on a 3-device mesh.
  (v) GIMMVFI_F(ff_iters=2) on two ranks against its own single process,
      its `prepare` sharded too (FlowFormer's query map by width).
 (vi) One rank with no group is `interpolate_sequential` on the padded
      pair, bit for bit.
(vii) On the same spawned ranks (`_rank_checks`), after (iii)-(v): the
      halo exchange against slicing (halos of 0, 3 and wider than a
      strip, float32 and bf16); the sharded instance norm against one
      process's, <= 1e-5 max(1, max|ref|); `prepare_sharded` against
      `prepare`, the flows <= 1e-4 relative, every other field <= 1e-5
      max(1, max|ref|), RAFT's correlation route (recorded at each lookup)
      that of one process at the default limit and at a limit between the
      strip's volume and the pair's (windowed); RAFT's encoder halo or loop
      halo set to 0 misses one process's flow by more than 1e-3; and
      GIMMVFI_F(ff_iters=2) at F_HW (weights at std 0.05, so that the flows
      reach tens of pixels and the cost memory moves them): its
      `prepare_sharded` against `prepare` under the same bounds, each
      rank's cost rows (recorded at `flowformer.cost_rows`) its own
      strip's queries of each direction and never the whole volume, and
      with the local vertical attention's halo or the decoder's loop halo
      set to 0, FlowFormer's flow misses one process's by more than 1e-3.
      At 3 ranks the strips of the 16 columns are 5, 5 and 6: edges off
      the local attention's grid of 7.
The halos' derivation and the strips' grid are checked on their own.
The JAX side of F's sharding is held by transitivity: one process's
GIMMVFI_F is held against JAX's in `tests/test_torch_gimmvfi_f.py`, and
JAX's `interpolate_spatial_sharded` is its `interpolate_sequential`
partitioned by GSPMD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.models.gimmvfi_r import GIMMVFI_R as JaxGIMMVFI_R
from gimmvfi_tpu.parallel.mesh import create_mesh
from gimmvfi_tpu.parallel.spatial import interpolate_spatial_sharded as jax_sharded
from gimmvfi_tpu_torch.flow import flowformer
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimm_core import splatting_weights
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_, instance_norm, instance_norm_sharded
from gimmvfi_tpu_torch.ops import corr as corr_ops
from gimmvfi_tpu_torch.parallel import dist as dist_ops
from gimmvfi_tpu_torch.parallel import spatial
from gimmvfi_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)
T_VALUES = [0.25, 0.6]
TWO = (128, 256)  # (iii), W split in two
THREE = (128, 128)  # (iv), padded to 144
F_HW = (128, 128)  # (v)


def _frames(hw, seed):
    return np.random.default_rng(seed).random((1, 2, *hw, 3), dtype=np.float32)


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


@pytest.fixture(scope="module")
def variables():
    img = _frames((128, 192), 0)
    model = JaxGIMMVFI_R(raft_iters=2, remat=False)
    init = jax.jit(lambda r, x: model.init(r, x, (0.5,)))(jax.random.PRNGKey(0), jnp.asarray(img))
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in init.items()}


@pytest.fixture(scope="module")
def model(variables):
    return load_jax_params(GIMMVFI_R(raft_iters=2, device="cpu"), variables["params"],
                           variables["batch_stats"])


@pytest.fixture(scope="module")
def f_model():
    return init_normal_(GIMMVFI_F(ff_iters=2, device="cpu"), 3)


def _case(family, model_kw, model, img, ds=None):
    return {"family": family, "model_kw": {**model_kw, "device": "cpu"}, "state": model.state_dict(),
            "img_xs": torch.from_numpy(img), "t_values": T_VALUES, "ds_factor": ds}


# between one rank's RAFT query window at TWO on two ranks (2 x 327,680
# bytes: 30 of the 32 1/8-scale columns against the whole map, float32)
# and the whole pair's (2 x 349,525): windowed only if the whole pair's
# volume decides
WINDOWED_LIMIT = 680_000
HALO_WIDTH, HALO_STRIPS = 37, {2: [(0, 12), (12, 37)], 3: [(0, 5), (5, 20), (20, 37)]}
NORM_STRIPS = {2: [(0, 16), (16, 40)], 3: [(0, 8), (8, 24), (24, 40)]}  # at stride 8 of 40 x 8


def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _prepare_on_rank(state, img, limit, halos=None):
    """`prepare_sharded` of the R model at `limit`, the correlation state
    type of each RAFT lookup, and with `halos` RAFT's flow alone."""
    model = GIMMVFI_R(raft_iters=2, device="cpu", corr_max_volume_bytes=limit)
    model.load_state_dict(state)
    routes, lookup = [], corr_ops.corr_lookup_any

    def recording(state, coords, *radius):
        routes.append(type(state).__name__)
        return lookup(state, coords, *radius)

    corr_ops.corr_lookup_any = recording
    try:
        with torch.inference_mode():
            prep = model.prepare_sharded(img)
            res = {}
            for k, v in prep.items():  # every tensor, the tuples' and the windowed state's
                parts = v if isinstance(v, tuple) else (v,)
                if isinstance(v, corr_ops.WindowedCorr):
                    parts = (v.f1, *v.f2_levels)
                for i, t in enumerate(p for p in parts if isinstance(p, torch.Tensor)):
                    res[f"{k}.{i}" if len(parts) > 1 else k] = t
            res["routes"] = routes[:model.flow_estimator.iters]
            pair = [255.0 * img[:, i].permute(0, 3, 1, 2) for i in range(2)]
            w8, world = img.shape[3] // 8, dist_ops.world_size()
            edges = [w8 * r // world for r in range(world + 1)]
            strips = list(zip(edges[:-1], edges[1:]))
            for name, h in (halos or {}).items():
                res[name] = model.flow_estimator.forward_sharded(*pair, strips, None, h)[0]
    finally:
        corr_ops.corr_lookup_any = lookup
    return res


F_STD = 0.05  # (vii)'s F weights: flows of tens of pixels at F_HW


def f_checks_model():
    """(vii)'s GIMMVFI_F, the same weights in every process."""
    return init_normal_(GIMMVFI_F(ff_iters=2, device="cpu"), 5, F_STD)


def _flat_tensors(prep: dict) -> dict:
    """Every tensor of a `prepare` dict, nested tuples and windowed states
    included, under dotted names."""
    out = {}

    def walk(name, v):
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, corr_ops.WindowedCorr):
            walk(name, (v.f1, *v.f2_levels))
        elif isinstance(v, (tuple, list)):
            for i, x in enumerate(v):
                walk(f"{name}.{i}", x)

    for k, v in prep.items():
        walk(k, v)
    return out


def _f_prepare_on_rank(halos=None):
    """`prepare_sharded` of (vii)'s F model at F_HW with the query count of
    each cost-row call (queries, keys), and with `halos` FlowFormer's flow
    alone."""
    model = f_checks_model()
    img = torch.from_numpy(_frames(F_HW, 6))
    rows, form = [], flowformer.cost_rows

    def recording(queries, keys):
        rows.append((queries.shape[2] * queries.shape[3], keys.shape[2] * keys.shape[3]))
        return form(queries, keys)

    flowformer.cost_rows = recording
    try:
        with torch.inference_mode():
            res = _flat_tensors(model.prepare_sharded(img))
            res["cost_rows"] = list(rows)  # the halo variants below form more
            pair = [255.0 * img[:, i].permute(0, 3, 1, 2) for i in range(2)]
            w8, world = F_HW[1] // 8, dist_ops.world_size()
            strips = spatial.strip_bounds(w8, world, 1)
            for name, h in (halos or {}).items():
                res[name] = model.flow_estimator.forward_sharded(*pair, strips, None, h)[0]
    finally:
        flowformer.cost_rows = form
    return res


def _rank_checks(cases_path, out_dir):
    """One rank of the `ranks` fixture: `interpolate_on_rank` over the
    cases, then (vii)'s checks on this rank, saved to `extra<r>.pt`."""
    spatial.interpolate_on_rank(cases_path, out_dir, 1)
    rank, world = dist_ops.rank(), dist_ops.world_size()
    res = {"halo": {}}
    whole = _seeded((2, 3, 2, HALO_WIDTH), 7)
    strips = HALO_STRIPS[world]
    a, b = strips[rank]
    for dtype in (torch.float32, torch.bfloat16):
        for halo in (0, 3, 14):
            res["halo"][str(dtype), halo] = dist_ops.exchange_halo(
                whole.to(dtype)[..., a:b], strips, halo, 3)
    x = _seeded((2, 4, 6, 40), 8) * 3 + 1
    a, b = NORM_STRIPS[world][rank]
    lo, hi = max(0, a - 5), min(40, b + 5)
    res["norm"] = instance_norm_sharded(x[..., lo:hi], a - lo, b - lo, 40)
    state = torch.load(cases_path, weights_only=False)[0]["state"]
    img = torch.from_numpy(_frames(TWO, 1))
    enc, it, up = GIMMVFI_R(raft_iters=2, device="cpu").flow_estimator.halos()
    res["prep"] = _prepare_on_rank(state, img, corr_ops.MAX_VOLUME_BYTES,
                                   {"no_encoder_halo": (0, it, up), "no_loop_halo": (enc, 0, up)}
                                   if world == 2 else None)
    if world == 2:
        res["prep_windowed"] = _prepare_on_rank(state, img, WINDOWED_LIMIT)
    lsa, it, up = f_checks_model().flow_estimator.halos()
    res["f_prep"] = _f_prepare_on_rank({"no_lsa_halo": (0, it, up), "no_loop_halo": (lsa, 0, up)}
                                       if world == 2 else None)
    torch.save(res, f"{out_dir}/extra{rank}.pt")


@pytest.fixture(scope="module")
def ranks(model, f_model, tmp_path_factory):
    """Each case's result on every rank: R at 128x256 and F at 128x128 on
    two ranks, R at 128x128 on three; and each rank's (vii) checks under
    "extra2" / "extra3"."""
    out = {}
    for world, cases in ((2, {"r": _case(GIMMVFI_R, {"raft_iters": 2}, model, _frames(TWO, 1)),
                              "f": _case(GIMMVFI_F, {"ff_iters": 2}, f_model, _frames(F_HW, 2))}),
                         (3, {"r3": _case(GIMMVFI_R, {"raft_iters": 2}, model, _frames(THREE, 3))})):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        torch.save(list(cases.values()), tmp / "cases.pt")
        dist_ops.spawn_ranks(_rank_checks, world, (str(tmp / "cases.pt"), str(tmp)),
                             rendezvous=str(tmp / "rendezvous"))
        per_rank = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]
        for i, name in enumerate(cases):
            out[name] = [res[i] for res in per_rank]
        out[f"extra{world}"] = [torch.load(tmp / f"extra{r}.pt", weights_only=False)
                                for r in range(world)]
    return out


@pytest.fixture(scope="module")
def one_process_prep(model):
    """(vii)'s one-process references at TWO: `prepare` at the default and
    the windowed limit with RAFT's routes, and RAFT's flow."""
    state = model.state_dict()
    img = torch.from_numpy(_frames(TWO, 1))
    return {"default": _prepare_on_rank(state, img, corr_ops.MAX_VOLUME_BYTES),
            "windowed": _prepare_on_rank(state, img, WINDOWED_LIMIT)}


def _jax_sharded(variables, img, devices):
    mesh = create_mesh(jax.devices()[:devices], data=1, space=devices)
    out = jax_sharded(JaxGIMMVFI_R(raft_iters=2, remat=False), variables, img,
                      np.asarray(T_VALUES, np.float32), mesh)
    return {k: np.asarray(v) for k, v in out.items()}


def _sequential(model, img, pad=0):
    img = torch.from_numpy(np.pad(img, [(0, 0)] * 3 + [(0, pad), (0, 0)], mode="edge"))
    out = interpolate_sequential(model, img, T_VALUES)
    return {k: v[..., :v.shape[-2] - pad, :] for k, v in out.items()}


def _max_abs(a, b):
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


def _stitched(model, prep, tv, strips, ds, halos):
    """The stages of `interpolate_spatial_sharded` over `strips` in one
    process, each on its window, the flow strips joined before the
    replicated 1/4-scale synthesis."""
    n, _, _, wk = prep["img0"].shape
    r1, r2 = halos
    flow_t = torch.cat([model.flow_strip(prep, tv, s, spatial.window(s, r1, wk))[0]
                        for s in strips], dim=2)
    img0, img1 = 2.0 * prep["img0"] - 1.0, 2.0 * prep["img1"] - 1.0
    q = model.synthesize_quarter(img0, img1, flow_t.permute(0, 3, 1, 2), prep["f8_up"],
                                 prep["corr_pyrs"], torch.full((n, 1, 1, 1), tv))
    imgs = [model.synthesize_strip(q, img0, img1, prep["f4_up"], s, spatial.window(s, r2, wk),
                                   prep["full_img"]) for s in strips]
    return torch.cat(imgs, dim=3).permute(0, 2, 3, 1), flow_t


# (frame, ds_factor, strips of the working width, uneven and on the grid of 4)
STITCH_CASES = [
    ((128, 256), None, [(0, 96), (96, 256)]),
    ((128, 256), None, [(0, 64), (64, 148), (148, 256)]),
    ((256, 256), 0.5, [(0, 48), (48, 128)]),
    ((256, 256), 0.5, [(0, 32), (32, 76), (76, 128)]),
]


@pytest.fixture(scope="module")
def decoded():
    """`decode_one` at t = 0.4 of the pair of each frame size and DS, with
    the flow scaler set so that the decoded flows reach 20 px, and its
    `prepare` output: {(hw, ds): (prep, ref)}, filled on first use."""
    return {}


def _stitch_gaps(model, decoded, hw, ds, strips, halos):
    """Max-abs gaps of the stitched image and flow to `decode_one`, and the
    decoded flow's largest magnitude."""
    tv = 0.4
    with torch.inference_mode():
        if (hw, ds) not in decoded:
            prep = model.prepare(torch.from_numpy(_frames(hw, 5)), ds)
            whole = (0, prep["img0"].shape[3])
            unit, _ = model.flow_strip({**prep, "scalers": torch.ones_like(prep["scalers"])}, tv,
                                       whole, whole)
            prep["scalers"] = prep["scalers"] * 0 + 20.0 / float(unit.abs().max())
            decoded[hw, ds] = prep, model.decode_one(prep, tv)
        prep, ref = decoded[hw, ds]
        img, flow = _stitched(model, prep, tv, strips, ds, halos)
    return (_max_abs(img, ref["imgt_pred"]), _max_abs(flow, ref["flowt"]),
            float(ref["flowt"].abs().max()))


@pytest.mark.parametrize("hw,ds,strips", STITCH_CASES)
def test_stitched_strips_match_decode_one(model, decoded, hw, ds, strips, record_property):
    img_gap, flow_gap, reach = _stitch_gaps(model, decoded, hw, ds, strips,
                                            spatial.halos(model, ds))
    record_property("imgt_pred_max_abs_err", img_gap)
    assert 10.0 <= reach <= 30.0
    assert img_gap <= 1e-5 and flow_gap <= 1e-5


@pytest.mark.parametrize("hw,ds,strips", STITCH_CASES[1::2])
def test_zero_halos_miss(model, decoded, hw, ds, strips):
    img_gap, flow_gap, _ = _stitch_gaps(model, decoded, hw, ds, strips, (0, 0))
    assert img_gap > 1e-3 and flow_gap > 1e-3


@pytest.mark.parametrize("ds,want", [(None, (8, 28)), (1.0, (8, 28)), (0.5, (8, 28)),
                                     (0.25, (8, 24))])
def test_halos_from_the_modules(model, ds, want):
    """R1 = the refiner's reach 5, R2 = 17 + 4 + [DS] 1 + ceil(6 ds), each
    rounded up to the grid of 4."""
    assert spatial.receptive_radius(model.res_conv) == 5
    assert spatial.receptive_radius(model.amt_final_decoder.convblock) == 17
    assert spatial.receptive_radius(model.amt_comb_block) == 6
    assert spatial.halos(model, ds) == want


@pytest.mark.parametrize("width,world", [(256, 2), (144, 3), (1024, 4), (136, 3), (16, 4)])
def test_strips_cover_the_width_on_the_grid(width, world):
    strips = spatial.strip_bounds(width, world)
    assert len(strips) == world and strips[0][0] == 0 and strips[-1][1] == width
    assert all(a % 4 == 0 and a < b for a, b in strips)
    assert all(x[1] == y[0] for x, y in zip(strips, strips[1:]))
    sizes = [b - a for a, b in strips]
    assert max(sizes) - min(sizes) <= 4


def test_strips_refuse_a_width_off_the_grid():
    with pytest.raises(ValueError):
        spatial.strip_bounds(130, 2)


def test_two_ranks_match_one_process(model, ranks):
    r0, r1 = ranks["r"]
    for k in ("imgt_pred", "flowt"):
        assert torch.equal(r0[k], r1[k])  # every rank has the whole result
    ref = _sequential(model, _frames(TWO, 1))
    assert r0["imgt_pred"].shape == ref["imgt_pred"].shape == (2, 1, *TWO, 3)
    assert _max_abs(r0["imgt_pred"], ref["imgt_pred"]) <= 1e-5
    assert _max_abs(r0["flowt"], ref["flowt"]) <= 1e-5


def test_two_ranks_match_jax_sharded(variables, ranks, record_property):
    got = ranks["r"][0]["imgt_pred"].numpy()
    ref = _jax_sharded(variables, _frames(TWO, 1), 2)["imgt_pred"]
    db = _psnr(got, ref)
    record_property("imgt_pred_psnr_db", db)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    assert db >= 60.0


def test_three_ranks_pad_crop_and_match_jax(model, variables, ranks, record_property):
    got = ranks["r3"][0]
    assert got["imgt_pred"].shape == (2, 1, *THREE, 3)
    assert got["flowt"].shape == (2, 1, *THREE, 2)
    ref = _sequential(model, _frames(THREE, 3), pad=16)  # 128 -> 144
    assert _max_abs(got["imgt_pred"], ref["imgt_pred"]) <= 1e-5
    assert _max_abs(got["flowt"], ref["flowt"]) <= 1e-5
    jref = _jax_sharded(variables, _frames(THREE, 3), 3)
    assert jref["imgt_pred"].shape == tuple(got["imgt_pred"].shape)
    db = _psnr(got["imgt_pred"].numpy(), jref["imgt_pred"])
    record_property("imgt_pred_psnr_db", db)
    np.testing.assert_allclose(got["imgt_pred"].numpy(), jref["imgt_pred"], atol=2e-5, rtol=1e-4)
    assert db >= 60.0


def test_f_on_two_ranks_matches_one_process(f_model, ranks):
    got = ranks["f"][0]
    ref = _sequential(f_model, _frames(F_HW, 2))
    assert got["imgt_pred"].shape == ref["imgt_pred"].shape
    assert _max_abs(got["imgt_pred"], ref["imgt_pred"]) <= 1e-5
    assert _max_abs(got["flowt"], ref["flowt"]) <= 1e-5


def test_one_rank_without_a_group_is_sequential_on_the_padded_pair(model):
    img = _frames((128, 132), 4)  # W 132 -> 136, a multiple of lcm(1, 8)
    got = spatial.interpolate_spatial_sharded(model, torch.from_numpy(img), T_VALUES)
    ref = _sequential(model, img, pad=4)
    assert got["imgt_pred"].shape == (2, 1, 128, 132, 3) and got["flowt"].shape == (2, 1, 128, 132, 2)
    assert all(torch.equal(got[k], ref[k]) for k in ("imgt_pred", "flowt"))


@pytest.mark.parametrize("world", [2, 3])
def test_exchange_halo_is_slicing(ranks, world):
    whole = _seeded((2, 3, 2, HALO_WIDTH), 7)
    for r, (a, b) in enumerate(HALO_STRIPS[world]):
        for dtype in (torch.float32, torch.bfloat16):
            for halo in (0, 3, 14):  # 14 spans more than one neighbour's strip
                got = ranks[f"extra{world}"][r]["halo"][str(dtype), halo]
                want = whole.to(dtype)[..., max(0, a - halo):min(HALO_WIDTH, b + halo)]
                assert got.dtype == dtype and torch.equal(got, want), (r, dtype, halo)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_instance_norm_matches_one_process(ranks, world):
    x = _seeded((2, 4, 6, 40), 8) * 3 + 1
    ref = instance_norm(x)
    for r, (a, b) in enumerate(NORM_STRIPS[world]):
        got = ranks[f"extra{world}"][r]["norm"]
        lo = max(0, a - 5)
        mine = got[..., a - lo:b - lo]
        assert _max_abs(mine, ref[..., a:b]) <= 1e-5 * max(1.0, float(ref.abs().max()))


def _hold_prep(model, got, ref):
    """The flows <= 1e-4 relative; the splat weights w1, w2 <= 1e-5 max(1,
    max|ref|) of one process's `splatting_weights` of the rank's own flows
    (their local-variance term, sqrt(E[f^2] - E[f]^2) over a 3x3 blur,
    cancels where the flow is smooth and turns the flows' float32 rounding
    into ~1e-4 of w: a function of the flows, not of the sharding); every
    other tensor, the correlation levels and the decoder heads included,
    <= 1e-5 max(1, max|ref|) of one process's."""
    with torch.inference_mode():
        w1, w2 = splatting_weights(got["flow01"], got["flow10"], model.alpha_v, model.alpha_fe)
    for k, v in ref.items():
        if k in ("routes", "no_encoder_halo", "no_loop_halo"):
            continue
        scale = float(v.abs().max())
        if k.startswith("flow") or k == "nflows":
            assert _max_abs(got[k], v) <= 1e-4 * scale, (k, _max_abs(got[k], v), scale)
        else:
            want = {"w1": w1, "w2": w2}.get(k, v)
            assert _max_abs(got[k], want) <= 1e-5 * max(1.0, scale), (k, _max_abs(got[k], want))


@pytest.mark.parametrize("world", [2, 3])
def test_prepare_sharded_matches_prepare(model, ranks, one_process_prep, world):
    ref = one_process_prep["default"]
    assert ref["routes"] == ["tuple"] * 2  # materialized at 128x256
    for got in ranks[f"extra{world}"]:
        assert got["prep"]["routes"] == ref["routes"]
        _hold_prep(model, got["prep"], ref)


def test_prepare_sharded_route_is_the_whole_pairs(model, ranks, one_process_prep):
    """At a limit that a strip's volume is under and the pair's over, every
    rank looks up the windowed state, as one process does."""
    ref = one_process_prep["windowed"]
    assert ref["routes"] == ["WindowedCorr"] * 2
    for got in ranks["extra2"]:
        assert got["prep_windowed"]["routes"] == ref["routes"]
        _hold_prep(model, got["prep_windowed"], ref)


@pytest.mark.parametrize("which", ["no_encoder_halo", "no_loop_halo"])
def test_zero_raft_halos_miss(model, ranks, which):
    img = torch.from_numpy(_frames(TWO, 1))
    with torch.inference_mode():
        ref = model.flow_estimator(*[255.0 * img[:, i].permute(0, 3, 1, 2) for i in range(2)])[0]
    for got in ranks["extra2"]:
        assert _max_abs(got["prep"][which], ref) > 1e-3


@pytest.fixture(scope="module")
def one_process_f_prep():
    """(vii)'s one-process F reference at F_HW: `prepare`, its cost-row
    calls, and FlowFormer's flow."""
    res = _f_prepare_on_rank()
    model = f_checks_model()
    img = torch.from_numpy(_frames(F_HW, 6))
    with torch.inference_mode():
        res["flow"] = model.flow_estimator(*[255.0 * img[:, i].permute(0, 3, 1, 2)
                                             for i in range(2)], bidir=True)[0]
    return res


@pytest.mark.parametrize("world", [2, 3])
def test_f_prepare_sharded_matches_prepare(ranks, one_process_f_prep, world):
    ref = {k: v for k, v in one_process_f_prep.items() if k not in ("cost_rows", "flow")}
    assert float(ref["flow01"].abs().max()) >= 10.0  # the flows cross the strips' edges
    for got in ranks[f"extra{world}"]:
        _hold_prep(f_checks_model(), got["f_prep"], ref)


@pytest.mark.parametrize("world", [2, 3])
def test_f_cost_rows_are_the_ranks_strip(ranks, one_process_f_prep, world):
    """One process forms the whole forward volume once (the reverse is its
    transpose); each rank forms only its strip's rows of each direction."""
    h8, w8 = F_HW[0] // 8, F_HW[1] // 8
    assert one_process_f_prep["cost_rows"] == [(h8 * w8, h8 * w8)]
    strips = spatial.strip_bounds(w8, world, 1)
    if world == 3:
        assert [b - a for a, b in strips] == [5, 5, 6]
    for (a, b), got in zip(strips, ranks[f"extra{world}"]):
        assert got["f_prep"]["cost_rows"] == [(h8 * (b - a), h8 * w8)] * 2


@pytest.mark.parametrize("which", ["no_lsa_halo", "no_loop_halo"])
def test_zero_flowformer_halos_miss(ranks, one_process_f_prep, which):
    for got in ranks["extra2"]:
        assert _max_abs(got["f_prep"][which], one_process_f_prep["flow"]) > 1e-3


def test_flowformer_halos_from_the_modules(f_model):
    """The local attention's windows of 7: 6; an iteration 6 + 6 + 2 = 14;
    the upsample 1."""
    assert f_model.flow_estimator.halos() == (6, 14, 1)


def test_halos_hold_at_other_options():
    """Two flow pairs, the softmax splat, AMT lookups of radius 3: the
    decode's and RAFT's halos come from the same convs."""
    model = GIMMVFI_R(raft_iters=2, device="cpu", num_flows=2, fwarp_type="softmax",
                      corr_radius=3, coord_range=(-0.5, 0.5))
    assert spatial.halos(model) == (8, 28) and spatial.halos(model, 0.25) == (8, 24)
    assert model.flow_estimator.halos() == (7, 14, 1)


def test_raft_halos_from_the_modules(model):
    """The encoders' strided reach 53 input columns over a stride of 8: 7;
    an iteration 6 + 6 + 2 = 14; the upsample 1."""
    from gimmvfi_tpu_torch.nn.layers import strided_reach

    raft = model.flow_estimator
    assert strided_reach(raft.fnet) == strided_reach(raft.cnet) == (53, 8)
    assert raft.halos() == (7, 14, 1)
