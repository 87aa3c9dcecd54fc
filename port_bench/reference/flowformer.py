"""FlowFormer (LatentCostFormer) with its two-stage Twins-SVT encoders,
inference, float32: plain copy of the port's mathematics. Parameter names
follow the FlowFormer state dict. `autocast_dtype` (the control's lower
precision) runs the whole estimator under `torch.autocast` in that dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .ops import conv, coords_grid, corr_lookup
from .raft import BasicMotionEncoder, FlowHead, SepConvGRU, convex_upsample_8x

LN_EPS = 1e-6


def pad_hw(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) bottom/right so H and W divide `mult`."""
    _, h, w, _ = x.shape
    ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv applied to a channels-last (B, H, W, C) grid."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the last two dims."""
    return torch.softmax((q @ k.transpose(-2, -1)).mul_(scale), dim=-1) @ v


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    """LSA: softmax attention within ws x ws windows, fused qkv. The zero
    pad to a multiple of ws takes part in the softmax (no mask), as in the
    reference, and is cropped afterwards."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        nh, ws = self.num_heads, self.ws
        hd = c // nh
        xp = pad_hw(x, ws)
        hp, wp = xp.shape[1:3]
        gh, gw = hp // ws, wp // ws
        # (B, gh, ws, gw, ws, 3, heads, hd) -> (3, B, groups, heads, ws*ws, hd)
        qkv = self.qkv(xp).view(b, gh, ws, gw, ws, 3, nh, hd)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, gh * gw, nh, ws * ws, hd)
        out = attend(qkv[0], qkv[1], qkv[2], hd**-0.5)
        out = out.view(b, gh, gw, nh, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
        out = out.reshape(b, hp, wp, c)[:, :h, :w]
        return self.proj(out)


class GlobalSubSampleAttn(nn.Module):
    """GSA: every query attends to keys and values sub-sampled by a VALID
    sr x sr conv (which floors a ragged edge), fused kv."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = self.q(x).view(b, h * w, nh, hd).transpose(1, 2)
        kv_in = self.norm(conv_nhwc(self.sr, x)) if self.sr_ratio > 1 else x
        m = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).view(b, m, 2, nh, hd).permute(2, 0, 3, 1, 4)
        out = attend(q, kv[0], kv[1], hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class TwinsBlock(nn.Module):
    """Pre-norm attention (LSA if ws > 1, else GSA) + MLP, both residual."""

    def __init__(self, dim: int, num_heads: int, ws: int, sr_ratio: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = (LocallyGroupedAttn(dim, num_heads, ws) if ws > 1
                     else GlobalSubSampleAttn(dim, num_heads, sr_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """VALID patch x patch conv, stride patch, then LayerNorm; NCHW in,
    channels-last out."""

    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class PosConv(nn.Module):
    """PEG: depthwise 3x3 conv plus the residual (key `proj.0`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x):
        return conv_nhwc(self.proj, x) + x


class TwinsSVTLarge2Stage(nn.Module):
    """twins_svt_large truncated to stages 0-1. forward(x): x (B, 3, H, W)
    normalized to [-1, 1]; returns (the 1/8 map, [the 1/4 map (128 ch),
    the 1/8 map (256 ch)]), NCHW."""

    def __init__(self, embed_dims=(128, 256), num_heads=(4, 8), depths=(2, 2),
                 sr_ratios=(8, 4), ws: int = 7):
        super().__init__()
        cins = (3,) + tuple(embed_dims[:-1])
        self.svt = nn.ModuleDict({
            "patch_embeds": nn.ModuleList(
                PatchEmbed(cin, dim, 4 if i == 0 else 2)
                for i, (cin, dim) in enumerate(zip(cins, embed_dims))),
            # even blocks LSA, odd blocks GSA
            "blocks": nn.ModuleList(
                nn.ModuleList(TwinsBlock(dim, heads, ws if j % 2 == 0 else 1, sr)
                              for j in range(depth))
                for dim, heads, depth, sr in zip(embed_dims, num_heads, depths, sr_ratios)),
            "pos_block": nn.ModuleList(PosConv(dim) for dim in embed_dims),
        })

    def forward(self, x):
        feats = []
        svt = self.svt
        for embed, blocks, pos in zip(svt["patch_embeds"], svt["blocks"], svt["pos_block"]):
            x = embed(x)
            for j, block in enumerate(blocks):
                x = block(x)
                if j == 0:
                    x = pos(x)
            x = x.permute(0, 3, 1, 2)
            feats.append(x)
        return x, feats


EPS5 = 1e-5


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
    (0 on the whole map)."""

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

    def forward(self, x, context):
        """x (B, H1, W1, D) with its context (B, H1, W1, ctx)."""
        y = self.norm1(x)
        y = self.attn(y, context)
        x = x + y
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    """A local then a global vertical block over the (H1, W1) source grid."""

    def __init__(self, dim=128):
        super().__init__()
        self.dim = dim
        self.local_block = VerticalBlock(dim, 8, 7, 4)
        self.global_block = VerticalBlock(dim, 8, 1, 4)

    def forward(self, x, size, context):
        """x (B*K, H1*W1, D); context (B*K, H1, W1, 256)."""
        h1, w1 = size
        xs = x.view(x.shape[0], h1, w1, self.dim)
        xs = self.global_block(self.local_block(xs, context), context)
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

    def forward(self, cost_maps, size, context):
        """cost_maps (B*H1*W1, 1, H2, W2); size (H1, W1); context (B, 256,
        H1, W1). Returns the cost memory (B*H1*W1, K, D)."""
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
            xv = vertical(xv, size, ctx)
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


# ----------------------------------------------------------------- GMA
class GMAAttention(nn.Module):
    """Content self-similarity over the context, one head of 128:
    softmax(q k^T / sqrt(128)) over all (H*W)^2 pairs."""

    def __init__(self, dim=128, dim_head=128):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap):
        """fmap (B, C, H, W) gives queries and keys: (B, H W, H W)."""
        q, k = self.to_qk(fmap).flatten(2).transpose(1, 2).chunk(2, dim=-1)
        return torch.softmax((q * self.dim_head**-0.5) @ k.transpose(1, 2), dim=-1)


class GMAAggregate(nn.Module):
    """fmap + gamma * (attention @ to_v(fmap))."""

    def __init__(self, dim=128, dim_head=128):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, fmap):
        b, _, h, w = fmap.shape
        v = self.to_v(fmap).flatten(2).transpose(1, 2)
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

    def forward(self, net, inp, corr, flow, attention):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
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
            cost_forward = corr_lookup(pyramid, coords1, radius=4)  # (B, 81, H1, W1)
            query = self.flow_token_encoder(cost_forward).permute(0, 2, 3, 1)
            query = query.reshape(b * h1 * w1, 1, self.query_dim)
            pe = linear_pe(coords1.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, 2), self.query_dim)
            cost_global = cross(query, key, value, pe).view(b, h1, w1, self.query_dim)
            corr = torch.cat([cost_global.permute(0, 3, 1, 2), cost_forward], dim=1)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta_flow

        flow_lowres = coords1 - coords0
        return convex_upsample_8x(flow_lowres, self.update_block.upsample_mask(net)), flow_lowres


# ---------------------------------------------------------------- top level
class FlowFormer(nn.Module):
    """FlowFormer with `iters` decoder iterations. forward(image1, image2,
    bidir=False): images (N, 3, H, W) in [0, 255]; returns (flow_up (N, 2,
    H, W), [context feature 1/4 (128 ch), 1/8 (256 ch)], the channel-
    converted feature map (256 ch, 1/8)), float32 NCHW. With `bidir` both
    directions go in one batched pass, forward in rows :N and backward in
    rows N:; the context encoder and the cost matmul run once."""

    def __init__(self, iters=32, autocast_dtype=None):
        super().__init__()
        self.iters = iters
        self.autocast_dtype = autocast_dtype
        self.context_encoder = TwinsSVTLarge2Stage()
        self.memory_encoder = MemoryEncoder()
        self.memory_decoder = MemoryDecoder(iters)

    def forward(self, image1, image2, bidir=False):
        if self.autocast_dtype is None:
            return self._forward(image1, image2, bidir)
        with torch.autocast(image1.device.type, dtype=self.autocast_dtype):
            out = self._forward(image1, image2, bidir)
        return tuple(x.float() if torch.is_tensor(x) else [f.float() for f in x] for x in out)

    def _forward(self, image1, image2, bidir):
        image1 = 2 * (image1.float() / 255.0) - 1.0
        image2 = 2 * (image2.float() / 255.0) - 1.0
        ctx_in = torch.cat([image1, image2], dim=0) if bidir else image1
        context, cfeat = self.context_encoder(ctx_in)
        memory, cost_maps, ffeat = self.memory_encoder(image1, image2, context, bidir)
        flow_up, _ = self.memory_decoder(memory, context, cost_maps)
        return flow_up, cfeat, ffeat

