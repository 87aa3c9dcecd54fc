"""FlowFormer (LatentCostFormer) optical flow, inference
(`gimmvfi_tpu/flow/flowformer.py`).

A Twins context encoder; a memory encoder that forms the all-pairs cost
volume of the channel-converted Twins features, patchifies every source
pixel's cost map and lets 8 latent tokens cross-attend to it, then
alternates latent self-attention with "vertical" Twins attention across
source pixels; a memory decoder of `iters` ConvGRU steps, each looking up a
9x9 cost window, cross-attending the flow token to the cost memory and
aggregating motion globally (GMA); a convex 8x upsample.

Convolutions are NCHW; attention works on (batch, tokens, channels) and on
channels-last token grids. Everything is float32: FlowFormer has no compute
dtype, inside a bf16 GIMMVFI_F too. Two loop invariants are hoisted as in
JAX: the cross-attention k/v over the cost memory run once before the
decoder loop, and the upsample-mask head once on the final hidden state.
Parameter names follow the reference state dict (keys of
`gimmvfi_tpu/utils/convert.py: convert_flowformer`); GMA's unused relative
position embedding has no parameter. LayerNorms use eps 1e-5 (Twins' own
1e-6 live in twins.py).

`FlowFormer.forward_sharded` is the bidirectional pass with the query map
split by width over the ranks of a process group (`parallel/spatial.py`):
both Twins encoders whole on every rank; the cost rows of the rank's
strip of 1/8-scale query columns against the whole other map, each
direction formed on its own (`cost_rows`); the cost perceiver on those
rows, its vertical attention exchanging a halo for the local windows
(`dist.exchange_halo`) and gathering the layer's input whole for the
global one's keys and values (`dist.gather_disjoint`); the decoder on the
strip, GMA's attention for its window's query rows against every key, a
halo exchange and a gather of the motion features an iteration; the
convex upsample on the strip; the flows gathered whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..nn.layers import conv, receptive_radius
from ..ops import corr as corr_ops
from ..ops.coords import coords_grid
from ..parallel import dist as dist_ops
from .raft import BasicMotionEncoder, FlowHead, SepConvGRU, convex_upsample_8x
from .twins import Mlp, TwinsSVTLarge2Stage, attend, conv_nhwc

EPS5 = 1e-5


@dataclass(frozen=True)
class QueryStrip:
    """This rank's query columns of the 1/8-scale map in a sharded pass:
    every rank's `strips` [a, b) in rank order, tiling the map's width;
    this rank's index; the process `group`; the halo in columns that the
    local vertical attention exchanges."""

    strips: tuple[tuple[int, int], ...]
    rank: int
    group: object
    lsa_halo: int

    @property
    def cols(self) -> tuple[int, int]:
        return self.strips[self.rank]

    @property
    def width(self) -> int:
        return self.strips[-1][1]

    def gather(self, part: torch.Tensor, dim: int, scale: int = 1) -> torch.Tensor:
        """The whole tensor from each rank's strip `part` on `dim`, `scale`
        elements a column."""
        a, b = self.cols
        return dist_ops.gather_disjoint(part, scale * a, scale * b, scale * self.width, dim,
                                        self.group)

    def widen(self, part: torch.Tensor, halo: int, dim: int) -> torch.Tensor:
        """This rank's strip `part` widened by `halo` columns on `dim`."""
        return dist_ops.exchange_halo(part, list(self.strips), halo, dim, self.group)


def cost_rows(queries: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Cost rows of the query map (N, C, h, wq) against the key map (N, C,
    h2, w2), without a sqrt(C) scale: (N, h wq, h2 w2), queries row-major."""
    return queries.flatten(2).transpose(1, 2) @ keys.flatten(2)


def grid_nhwc(batch: int, h: int, w: int, device) -> torch.Tensor:
    """(B, H, W, 2) float32 grid of (x, y) pixel coordinates."""
    return coords_grid(batch, h, w, device).permute(0, 2, 3, 1)


def linear_pe(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """LinearPositionEmbeddingSine: coords (..., 2) as (x, y) -> (..., dim)
    [sin(3.14 x f) | cos(3.14 x f) | sin(3.14 y f) | cos(3.14 y f)],
    f = k / 200 for k < dim / 4. The reference's literal 3.14 is kept."""
    freqs = torch.arange(dim // 4, dtype=torch.float32, device=coords.device) * (1.0 / 200.0)
    x = coords[..., 0:1] * freqs
    y = coords[..., 1:2] * freqs
    return torch.cat([torch.sin(3.14 * x), torch.cos(3.14 * x),
                      torch.sin(3.14 * y), torch.cos(3.14 * y)], dim=-1)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain multi-head softmax attention: q (B, I, D), k/v (B, J, D)."""
    b, i, d = q.shape
    hd = d // heads
    qh = q.view(b, i, heads, hd).transpose(1, 2)
    kh = k.reshape(b, -1, heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, heads, v.shape[-1] // heads).transpose(1, 2)
    return attend(qh, kh, vh, (d / heads) ** -0.5).transpose(1, 2).reshape(b, i, -1)


def FFN(dim: int) -> nn.Sequential:
    """Linear, exact GELU, (dropout), Linear: keys `.0` and `.3`."""
    return nn.Sequential(nn.Linear(dim, dim), nn.GELU(), nn.Identity(), nn.Linear(dim, dim))


# -------------------------------------------------------- cost patch embed
class CostPatchEmbed(nn.Module):
    """Patchify cost maps (B', 1, H2, W2), zero-padded to a multiple of 8,
    with three stride-2 6x6 convs, add the patch centres' linear PE, a 1x1
    conv FFN and a LayerNorm. Returns tokens (B', H3*W3, 2*dim)."""

    def __init__(self, dim: int = 64, patch_size: int = 8):
        super().__init__()
        self.dim, self.patch_size = dim, patch_size
        self.proj = nn.Sequential(
            nn.Conv2d(1, dim // 4, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(dim // 4, dim // 2, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(dim // 2, dim, 6, 2, 2))
        self.ffn_with_coord = nn.Sequential(
            nn.Conv2d(2 * dim, 2 * dim, 1), nn.ReLU(), nn.Conv2d(2 * dim, 2 * dim, 1))
        self.norm = nn.LayerNorm(2 * dim, eps=EPS5)

    def forward(self, x):
        b = x.shape[0]
        p = self.patch_size
        ph, pw = (p - x.shape[2] % p) % p, (p - x.shape[3] % p) % p
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        x = self.proj(x)
        h3, w3 = x.shape[2:]
        centres = grid_nhwc(1, h3, w3, x.device) * p + p / 2.0
        pe = linear_pe(centres, self.dim).permute(0, 3, 1, 2).expand(b, -1, -1, -1)
        x = self.ffn_with_coord(torch.cat([x, pe], dim=1))
        return self.norm(x.flatten(2).transpose(1, 2))


# ------------------------------------------------- perceiver input / latent
class AttentionLayer(nn.Module):
    """Pre-norm q/k/v attention, output projection and FFN, both residual.
    Cross-attention (the perceiver input layer) when forward gets `tgt`,
    self-attention over the latent tokens otherwise."""

    def __init__(self, dim: int = 128, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=EPS5)
        self.norm2 = nn.LayerNorm(dim, eps=EPS5)
        self.q, self.k, self.v, self.proj = (nn.Linear(dim, dim) for _ in range(4))
        self.ffn = FFN(dim)

    def forward(self, x, tgt=None):
        h = self.norm1(x)
        src = h if tgt is None else tgt
        x = x + self.proj(_mha(self.q(h), self.k(src), self.v(src), self.heads))
        return x + self.ffn(self.norm2(x))


# -------------------------------------------- vertical (Twins RPE+context)
class _RPEContextAttn(nn.Module):
    """The q/k/v/proj and context projection shared by the two vertical
    attentions: q and k see [x, context_proj(context)] plus a linear PE."""

    def __init__(self, dim: int, heads: int, ctx_dim: int = 256, vert_c_dim: int = 64):
        super().__init__()
        self.heads = heads
        self.context_proj = nn.Linear(ctx_dim, vert_c_dim)
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.proj = nn.Linear(dim, dim)


class LocallyGroupedAttnRPEContext(_RPEContextAttn):
    """LSA over 7x7 windows with the window-local linear PE. x and [x, ctx]
    are zero-padded to a multiple of ws, and the PE is added to the padded
    tokens too. `x0`, the global column of x's first, aligns the windows
    with the whole map's grid: x is zero-padded on the left by x0 % ws
    (`forward_sharded`)."""

    def __init__(self, dim=128, heads=8, ws=7, vert_c_dim=64):
        super().__init__(dim, heads, vert_c_dim=vert_c_dim)
        self.ws = ws
        self.k = nn.Linear(dim + vert_c_dim, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x, context, x0=0):
        b, h, w, c = x.shape
        ws, nh = self.ws, self.heads
        hd = c // nh
        x_qk = torch.cat([x, self.context_proj(context)], dim=-1)
        c_qk = x_qk.shape[-1]
        off = x0 % ws
        hp, wp = h + (ws - h % ws) % ws, off + w + (ws - (off + w) % ws) % ws
        gh, gw = hp // ws, wp // ws

        def windows(t):
            t = F.pad(t, (0, 0, off, wp - w - off, 0, hp - h))
            return t.reshape(b, gh, ws, gw, ws, -1).transpose(2, 3).reshape(b, gh * gw, ws * ws, -1)

        def heads(t):
            return t.view(b, gh * gw, ws * ws, nh, hd).transpose(2, 3)

        v = self.v(windows(x))
        pe = linear_pe(grid_nhwc(1, ws, ws, x.device), c_qk).view(1, 1, ws * ws, c_qk)
        xq = windows(x_qk) + pe
        out = attend(heads(self.q(xq)), heads(self.k(xq)), heads(v), hd**-0.5)
        out = out.transpose(2, 3).reshape(b, gh, gw, ws, ws, c).transpose(2, 3)
        return self.proj(out.reshape(b, hp, wp, c)[:, :h, off:off + w])

    def forward_sharded(self, x, context, shard: QueryStrip):
        """x (B, H1, b - a, C), this rank's strip; context (B, H1, W1, ctx)
        whole. Every window that meets the strip lies within ws - 1 columns
        of it: the strip widened by `shard.lsa_halo` (one exchange) holds
        them when that is ws - 1 or more."""
        (a, b), halo = shard.cols, shard.lsa_halo
        lo = max(0, a - halo)
        xw = shard.widen(x, halo, 2)
        return self.forward(xw, context[:, :, lo:lo + xw.shape[2]], lo)[:, :, a - lo:b - lo]


class GlobalSubSampleAttnRPEContext(_RPEContextAttn):
    """GSA: keys from [x, ctx] and values from x, each sub-sampled by its own
    VALID sr x sr conv and normed by one shared LayerNorm; x and [x, ctx] are
    zero-padded to a multiple of sr; linear PEs on the padded query grid and
    on the sub-sampled grid (in query pixels)."""

    def __init__(self, dim=128, heads=8, sr_ratio=4, vert_c_dim=64):
        super().__init__(dim, heads, vert_c_dim=vert_c_dim)
        self.sr_ratio = sr_ratio
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.sr_key = nn.Conv2d(dim + vert_c_dim, dim, sr_ratio, sr_ratio)
        self.sr_value = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
        self.norm = nn.LayerNorm(dim, eps=EPS5)

    def _padded(self, x, context):
        """x and [x, ctx] zero-padded to a multiple of sr, and the padded
        size."""
        _, h, w, _ = x.shape
        sr = self.sr_ratio
        x_qk = torch.cat([x, self.context_proj(context)], dim=-1)
        hp, wp = h + (sr - h % sr) % sr, w + (sr - w % sr) % sr
        if (hp, wp) != (h, w):
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
            x_qk = F.pad(x_qk, (0, 0, 0, wp - w, 0, hp - h))
        return x, x_qk, hp, wp

    def _keys_values(self, x, x_qk, hp, wp):
        """The heads' keys and values of the padded map."""
        b, c, sr, nh = x.shape[0], x.shape[-1], self.sr_ratio, self.heads
        x_ss = self.norm(conv_nhwc(self.sr_value, x))
        xqk_ss = self.norm(conv_nhwc(self.sr_key, x_qk))
        hs, ws_ = hp // sr, wp // sr
        k = self.k(xqk_ss + linear_pe(grid_nhwc(1, hs, ws_, x.device) * sr, c))
        k = k.view(b, hs * ws_, nh, c // nh).transpose(1, 2)
        v = self.v(x_ss).view(b, hs * ws_, nh, c // nh).transpose(1, 2)
        return k, v

    def forward(self, x, context):
        b, h, w, c = x.shape
        nh = self.heads
        hd = c // nh
        x, x_qk, hp, wp = self._padded(x, context)
        q = self.q(x_qk + linear_pe(grid_nhwc(1, hp, wp, x.device), x_qk.shape[-1]))
        q = q.view(b, hp * wp, nh, hd).transpose(1, 2)
        out = attend(q, *self._keys_values(x, x_qk, hp, wp), hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, hp, wp, c)[:, :h, :w])

    def forward_sharded(self, x, context, shard: QueryStrip):
        """x (B, H1, b - a, C), this rank's strip; context (B, H1, W1, ctx)
        whole. The keys and values come from the whole map, gathered (one
        all-reduce) and padded as one process pads it; the queries are the
        strip's, with the padded grid's PE at their global columns."""
        (a, b), (bt, h, _, c) = shard.cols, x.shape
        nh = self.heads
        hd = c // nh
        whole, x_qk, hp, wp = self._padded(shard.gather(x, 2), context)
        pe = linear_pe(grid_nhwc(1, hp, wp, x.device)[:, :h, a:b], x_qk.shape[-1])
        q = self.q(x_qk[:, :h, a:b] + pe).view(bt, h * (b - a), nh, hd).transpose(1, 2)
        out = attend(q, *self._keys_values(whole, x_qk, hp, wp), hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(bt, h, b - a, c))


class VerticalBlock(nn.Module):
    """Twins block with an RPE+context attention (local if ws > 1, global
    sub-sampled otherwise); LayerNorm eps 1e-5."""

    def __init__(self, dim=128, heads=8, ws=7, sr_ratio=4, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS5)
        self.attn = (LocallyGroupedAttnRPEContext(dim, heads, ws) if ws > 1
                     else GlobalSubSampleAttnRPEContext(dim, heads, sr_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=EPS5)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, context, shard: QueryStrip | None = None):
        """x (B, H1, W1, D) with its context (B, H1, W1, ctx); with `shard`,
        x is this rank's strip and the context whole."""
        y = self.norm1(x)
        y = self.attn(y, context) if shard is None else self.attn.forward_sharded(y, context, shard)
        x = x + y
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    """A local then a global vertical block over the (H1, W1) source grid."""

    def __init__(self, dim=128):
        super().__init__()
        self.dim = dim
        self.local_block = VerticalBlock(dim, 8, 7, 4)
        self.global_block = VerticalBlock(dim, 8, 1, 4)

    def forward(self, x, size, context, shard: QueryStrip | None = None):
        """x (B*K, H1*W1, D); context (B*K, H1, W1, 256). With `shard`, x
        is this rank's strip, `size` its (H1, b - a), the context whole."""
        h1, w1 = size
        xs = x.view(x.shape[0], h1, w1, self.dim)
        xs = self.global_block(self.local_block(xs, context, shard), context, shard)
        return xs.reshape(x.shape[0], h1 * w1, self.dim)


# ----------------------------------------------------- cost perceiver
class CostPerceiverEncoder(nn.Module):
    """Patchify every cost map, let K latent tokens cross-attend to it, then
    `depth` rounds of latent self-attention and vertical attention, with a
    residual around the rounds.

    The patch embed and the input layer work map by map, so they run over
    chunks of `MAP_CHUNK` maps: the result is the same, and the patch
    embed's largest activation is held for one chunk only."""

    MAP_CHUNK = 4096

    def __init__(self, depth=3, latent_tokens=8, latent_dim=128, input_dim=64):
        super().__init__()
        self.patch_embed = CostPatchEmbed(input_dim)
        self.latent_tokens = nn.Parameter(torch.randn(1, latent_tokens, latent_dim))
        self.input_layer = AttentionLayer(latent_dim)
        self.encoder_layers = nn.ModuleList(AttentionLayer(latent_dim) for _ in range(depth))
        self.vertical_encoder_layers = nn.ModuleList(
            VerticalSelfAttentionLayer(latent_dim) for _ in range(depth))

    def forward(self, cost_maps, size, context, shard: QueryStrip | None = None):
        """cost_maps (B*H1*W1, 1, H2, W2); size (H1, W1); context (B, 256,
        H1, W1). Returns the cost memory (B*H1*W1, K, D). With `shard` the
        maps are this rank's strip's queries, `size` is (H1, b - a) and the
        context stays whole."""
        h1, w1 = size
        bp = cost_maps.shape[0]
        b = bp // (h1 * w1)
        k_tok, d = self.latent_tokens.shape[1:]
        x = torch.cat([
            self.input_layer(self.latent_tokens.expand(chunk.shape[0], -1, -1),
                             self.patch_embed(chunk))
            for chunk in cost_maps.split(self.MAP_CHUNK)])
        short_cut = x
        # vertical-token row j gets context[j // K] (repeat_interleave): the
        # reference's `.repeat` tiling would give context[j % B] and cross-wire
        # the two directions of a bidirectional batch
        ctx = torch.repeat_interleave(context.permute(0, 2, 3, 1), k_tok, dim=0)
        for layer, vertical in zip(self.encoder_layers, self.vertical_encoder_layers):
            x = layer(x)
            xv = x.view(b, h1 * w1, k_tok, d).transpose(1, 2).reshape(b * k_tok, h1 * w1, d)
            xv = vertical(xv, size, ctx, shard)
            x = xv.view(b, k_tok, h1 * w1, d).transpose(1, 2).reshape(bp, k_tok, d)
        return x + short_cut


# ----------------------------------------------------------- memory encoder
class MemoryEncoder(nn.Module):
    """Twins features of both images, a bias-free 1x1 channel converter, the
    float32 all-pairs cost volume without a sqrt(C) scale, and the cost
    perceiver. With `bidir` the reverse volume is the forward one
    transposed."""

    def __init__(self):
        super().__init__()
        self.feat_encoder = TwinsSVTLarge2Stage()
        self.channel_convertor = nn.Conv2d(256, 256, 1, bias=False)
        self.cost_perceiver_encoder = CostPerceiverEncoder()

    def forward(self, img1, img2, context, bidir=False):
        n = img1.shape[0]
        feats, _ = self.feat_encoder(torch.cat([img1, img2], dim=0))
        feats = self.channel_convertor(feats)
        h, w = feats.shape[2:]
        corr = cost_rows(feats[:n], feats[n:])  # (N, HW source, HW target)
        if bidir:
            corr = torch.cat([corr, corr.transpose(1, 2)], dim=0)
        cost_maps = corr.reshape(-1, 1, h, w)
        memory = self.cost_perceiver_encoder(cost_maps, (h, w), context)
        return memory, cost_maps, (feats if bidir else feats[:n])

    def forward_sharded(self, img1, img2, context, shard: QueryStrip):
        """`forward(..., bidir=True)` for this rank's strip of queries: the
        features whole, the cost rows of the strip's columns of each
        direction's query map against the whole other map (each formed on
        its own), the perceiver on them. Returns (the strip's memory, its
        cost maps, the whole feature map)."""
        n = img1.shape[0]
        feats, _ = self.feat_encoder(torch.cat([img1, img2], dim=0))
        feats = self.channel_convertor(feats)
        (a, b), (h, w) = shard.cols, feats.shape[2:]
        corr = torch.cat([cost_rows(feats[:n, ..., a:b], feats[n:]),
                          cost_rows(feats[n:, ..., a:b], feats[:n])], dim=0)
        cost_maps = corr.reshape(-1, 1, h, w)
        memory = self.cost_perceiver_encoder(cost_maps, (h, b - a), context, shard)
        return memory, cost_maps, feats


# ----------------------------------------------------------------- GMA
class GMAAttention(nn.Module):
    """Content self-similarity over the context, one head of 128:
    softmax(q k^T / sqrt(128)) over all (H*W)^2 pairs."""

    def __init__(self, dim=128, dim_head=128):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap, keys=None):
        """fmap (B, C, H, W) gives the queries, and the keys too unless
        `keys` (B, C, H', W') does: (B, H W, H' W')."""
        q, k = self.to_qk(fmap).flatten(2).transpose(1, 2).chunk(2, dim=-1)
        if keys is not None:
            k = self.to_qk(keys).flatten(2).transpose(1, 2).chunk(2, dim=-1)[1]
        return torch.softmax((q * self.dim_head**-0.5) @ k.transpose(1, 2), dim=-1)


class GMAAggregate(nn.Module):
    """fmap + gamma * (attention @ to_v(values)), the values fmap itself
    unless given (the whole map, for a window's attention rows)."""

    def __init__(self, dim=128, dim_head=128):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, fmap, values=None):
        b, _, h, w = fmap.shape
        v = self.to_v(fmap if values is None else values).flatten(2).transpose(1, 2)
        out = (attn @ v).transpose(1, 2).reshape(b, -1, h, w)
        return fmap + self.gamma * out


class GMAUpdateBlock(nn.Module):
    """Motion encoder (cost planes 81 + 64), GMA aggregate, SepConvGRU over
    [inp, motion, global motion], flow head; `mask` is the convex-upsample
    mask head, applied once after the loop (`upsample_mask`)."""

    def __init__(self, hidden_dim=128):
        super().__init__()
        # float32: its two 3x3 convs over 256 channels are GEMMs (`GemmConv2d`)
        self.encoder = BasicMotionEncoder(corr_planes=81 + 64)
        self.gru = SepConvGRU(hidden_dim, 3 * 128)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(conv(128, 256, 3, 1, 1), nn.ReLU(), conv(256, 64 * 9, 1, 1, 0))
        self.aggregator = GMAAggregate()

    def forward(self, net, inp, corr, flow, attention, gather=None):
        """`gather`, in a sharded pass: this window's motion features to
        the whole map's (the values of GMA's aggregate)."""
        motion = self.encoder(flow, corr)
        whole = None if gather is None else gather(motion)
        motion_global = self.aggregator(attention, motion, whole)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return net, self.flow_head(net)

    def upsample_mask(self, net):
        return 0.25 * self.mask(net)


# ------------------------------------------------------------ memory decoder
class DecoderCrossAttention(nn.Module):
    """The flow token cross-attends to the cost memory; k/v are projected
    once by the caller (`k`, `v` live here for the state-dict keys)."""

    def __init__(self, dim=64, memory_dim=128, heads=8):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=EPS5)
        self.norm2 = nn.LayerNorm(dim, eps=EPS5)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(memory_dim, dim)
        self.v = nn.Linear(memory_dim, dim)
        self.proj = nn.Linear(2 * dim, dim)
        self.ffn = FFN(dim)

    def forward(self, query, key, value, coord_pe):
        q = self.q(self.norm1(query) + coord_pe)
        x = query + self.proj(torch.cat([_mha(q, key, value, self.heads), query], dim=-1))
        return x + self.ffn(self.norm2(x))


class MemoryDecoder(nn.Module):
    """`depth` decoder iterations from the cost memory, then the mask head
    and the convex 8x upsample."""

    def __init__(self, depth=32, query_dim=64):
        super().__init__()
        self.depth, self.query_dim = depth, query_dim
        self.proj = conv(256, 256, 1, 1, 0)
        self.att = GMAAttention()
        self.decoder_layer = nn.Module()
        self.decoder_layer.cross_attend = DecoderCrossAttention(query_dim)
        self.flow_token_encoder = nn.Sequential(
            conv(81, query_dim, 1, 1, 0), nn.GELU(), conv(query_dim, query_dim, 1, 1, 0))
        self.update_block = GMAUpdateBlock()

    def forward(self, memory, context, cost_maps):
        b, _, h1, w1 = context.shape
        context = self.proj(context)
        net = torch.tanh(context[:, :128])
        inp = F.relu(context[:, 128:])
        attention = self.att(inp)
        cross = self.decoder_layer.cross_attend
        key, value = cross.k(memory), cross.v(memory)  # loop-invariant
        pyramid = (cost_maps.view(b, h1 * w1, *cost_maps.shape[2:]),)

        coords0 = coords_grid(b, h1, w1, context.device)
        coords1 = coords0
        for _ in range(self.depth):
            # as the reference, no gradient flows through the coordinates
            # from one iteration into the next
            coords1 = coords1.detach()
            cost_forward = corr_ops.corr_lookup(pyramid, coords1, radius=4)  # (B, 81, H1, W1)
            query = self.flow_token_encoder(cost_forward).permute(0, 2, 3, 1)
            query = query.reshape(b * h1 * w1, 1, self.query_dim)
            pe = linear_pe(coords1.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, 2), self.query_dim)
            cost_global = cross(query, key, value, pe).view(b, h1, w1, self.query_dim)
            corr = torch.cat([cost_global.permute(0, 3, 1, 2), cost_forward], dim=1)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta_flow

        flow_lowres = coords1 - coords0
        return convex_upsample_8x(flow_lowres, self.update_block.upsample_mask(net)), flow_lowres

    def forward_sharded(self, memory, context, cost_maps, shard: QueryStrip, it: int, up: int):
        """`forward` for this rank's strip of queries: memory and cost_maps
        are the strip's (`MemoryEncoder.forward_sharded`), the context
        whole. GMA's attention once for the query rows of the strip widened
        by `it` against every key. Each iteration: the lookup and the
        cross-attention on the strip; its hidden state, lookup features and
        coordinates widened by `it` (one exchange); the update block on
        that window, the motion features of the strip gathered whole for
        GMA's values (one all-reduce); cropped back. Then the mask head and
        the convex upsample on the strip widened by `up`. Returns the
        strip's flow_up (B, 2, 8 H1, 8 (b - a))."""
        b, _, h1, w1 = context.shape
        (a, bb), q_dim, dev = shard.cols, self.query_dim, context.device
        lo, hi = max(0, a - it), min(w1, bb + it)
        mine = slice(a - lo, bb - lo)
        context = self.proj(context)
        net = torch.tanh(context[:, :128, :, a:bb])
        inp = F.relu(context[:, 128:])
        inp_w = inp[..., lo:hi]
        attention = self.att(inp_w, inp)
        cross = self.decoder_layer.cross_attend
        key, value = cross.k(memory), cross.v(memory)  # loop-invariant
        pyramid = (cost_maps.view(b, h1 * (bb - a), *cost_maps.shape[2:]),)

        def gather(motion_w):
            return shard.gather(motion_w[..., mine], 3)

        coords0 = coords_grid(b, h1, hi - lo, dev, x0=lo)
        coords1 = coords0[..., mine]
        for _ in range(self.depth):
            coords1 = coords1.detach()
            cost_forward = corr_ops.corr_lookup(pyramid, coords1, radius=4)
            query = self.flow_token_encoder(cost_forward).permute(0, 2, 3, 1).reshape(-1, 1, q_dim)
            pe = linear_pe(coords1.permute(0, 2, 3, 1).reshape(-1, 1, 2), q_dim)
            cost_global = cross(query, key, value, pe).view(b, h1, bb - a, q_dim)
            state = torch.cat([net, cost_global.permute(0, 3, 1, 2), cost_forward, coords1], dim=1)
            net_w, corr_w, coords_w = shard.widen(state, it, 3).split(
                [net.shape[1], q_dim + cost_forward.shape[1], 2], dim=1)
            net_w, delta_flow = self.update_block(net_w, inp_w, corr_w, coords_w - coords0,
                                                  attention, gather)
            net = net_w[..., mine]
            coords1 = coords1 + delta_flow[..., mine]

        net_u, coords_u = shard.widen(torch.cat([net, coords1], dim=1), up, 3).split(
            [net.shape[1], 2], dim=1)
        ulo = max(0, a - up)
        flow = coords_u - coords_grid(b, h1, coords_u.shape[3], dev, x0=ulo)
        flow_up = convex_upsample_8x(flow, self.update_block.upsample_mask(net_u))
        return flow_up[..., 8 * (a - ulo):8 * (bb - ulo)]


# ---------------------------------------------------------------- top level
class FlowFormer(nn.Module):
    """FlowFormer with `iters` decoder iterations. forward(image1, image2,
    bidir=False): images (N, 3, H, W) in [0, 255]; returns (flow_up (N, 2,
    H, W), [context feature 1/4 (128 ch), 1/8 (256 ch)], the channel-
    converted feature map (256 ch, 1/8)), float32 NCHW. With `bidir` both
    directions go in one batched pass, forward in rows :N and backward in
    rows N:; the context encoder and the cost matmul run once.

    The module is built on `device`, the CUDA card when None; the CPU only
    when asked (`device="cpu"`). Without a card the default raises."""

    def __init__(self, iters=32, device=None):
        super().__init__()
        self.iters = iters
        self.context_encoder = TwinsSVTLarge2Stage()
        self.memory_encoder = MemoryEncoder()
        self.memory_decoder = MemoryDecoder(iters)
        self.to(torch.device("cuda") if device is None else device)

    def forward(self, image1, image2, bidir=False):
        image1 = 2 * (image1.float() / 255.0) - 1.0
        image2 = 2 * (image2.float() / 255.0) - 1.0
        ctx_in = torch.cat([image1, image2], dim=0) if bidir else image1
        context, cfeat = self.context_encoder(ctx_in)
        memory, cost_maps, ffeat = self.memory_encoder(image1, image2, context, bidir)
        flow_up, _ = self.memory_decoder(memory, context, cost_maps)
        return flow_up, cfeat, ffeat

    def halos(self) -> tuple[int, int, int]:
        """The halos of `forward_sharded`, in 1/8-scale columns, from the
        modules: (the local vertical attention, one decoder iteration, the
        upsample).
          * A ws x ws window of the local attention that meets a strip lies
            within ws - 1 = 6 columns of it.
          * An iteration's lookup and cross-attention are pointwise in the
            query and GMA's aggregate reads the whole gathered map, so its
            reach is the sum of k // 2 over the motion encoder's, the GRU's
            and the flow head's convs: 6 + 6 + 2 = 14.
          * The upsample: the mask head's 3x3 conv over the hidden state and
            the 3x3 unfold of the flow each read 1."""
        vertical = self.memory_encoder.cost_perceiver_encoder.vertical_encoder_layers[0]
        ub = self.memory_decoder.update_block
        it = (receptive_radius(ub.encoder) + receptive_radius(ub.gru)
              + receptive_radius(ub.flow_head))
        return vertical.local_block.attn.ws - 1, it, max(1, receptive_radius(ub.mask))

    def forward_sharded(self, image1, image2, strips: list[tuple[int, int]], group=None,
                        halos: tuple[int, int, int] | None = None):
        """`forward(image1, image2, bidir=True)` with the query map split by
        width over the ranks of `group` (the default group if None):
        `strips` are every rank's columns [a, b) at 1/8 scale, in rank
        order, tiling W / 8. Every rank passes the whole pair; each returns
        `forward`'s results, whole, equal to one process's up to float
        rounding. On this rank, with `halos` (`FlowFormer.halos()` if None)
        (lsa, it, up) in 1/8 columns:
          1. both Twins encoders and the channel converter whole;
          2. the cost rows of the strip's queries of each direction against
             the whole other map (`MemoryEncoder.forward_sharded`), never
             the whole volume;
          3. the cost perceiver on them: the patch embed, the input layer
             and the latent self-attention map by map; each vertical layer's
             local attention on the strip widened by `lsa` (one exchange),
             its global attention's keys and values over the layer's input
             gathered whole (one all-reduce);
          4. the decoder on the strip with `it` and `up`
             (`MemoryDecoder.forward_sharded`), its flows gathered whole.
        H and W must be multiples of 8. Without a group, `forward`."""
        if not dist_ops.group_up():
            return self(image1, image2, bidir=True)
        _, _, h, w = image1.shape
        if h % 8 or w % 8 or strips[-1][1] != w // 8 or strips[0][0] != 0:
            raise ValueError(f"the strips {strips} do not tile the 1/8-scale width of a "
                             f"{h}x{w} frame (a multiple of 8 a side)")
        lsa, it, up = self.halos() if halos is None else halos
        shard = QueryStrip(tuple(strips), dist.get_rank(group), group, lsa)
        image1 = 2 * (image1.float() / 255.0) - 1.0
        image2 = 2 * (image2.float() / 255.0) - 1.0
        context, cfeat = self.context_encoder(torch.cat([image1, image2], dim=0))
        memory, cost_maps, ffeat = self.memory_encoder.forward_sharded(image1, image2, context,
                                                                       shard)
        flow_up = self.memory_decoder.forward_sharded(memory, context, cost_maps, shard, it, up)
        return shard.gather(flow_up, 3, 8), cfeat, ffeat
