"""State-space and linear-attention mixers: Mamba2 (SSD) and RWKV6 (Finch),
counterpart of ``repro.models.ssm``.

Both run in their chunked matmul form: within a chunk the contributions
are causal [Q, Q] products, and the state flows from chunk to chunk
through a Python loop (the reference's ``lax.scan`` over chunks).  The
big projections (Mamba2's ``in_proj`` / ``out_proj``, RWKV6's ``wr wk wv
wg wo ck cv cr``) are tagged linears, so they run the port's schemes and
kernels; the recurrence parameters (conv, dt, A, D, the decay LoRA ``w1``
/ ``w2``, ``mu``, ``u``, ``ln_x``) have no large matrix and stay fp, held
as buffers (frozen: only adapters train, as in the reference).

The ragged steps (:func:`mamba2_chunk_step`, :func:`rwkv6_time_mix_ragged`)
advance slot b's state by exactly ``n_new[b]`` tokens: masked rows are
identity in the recurrence (decay forced to 1, input to 0), so a slot with
``n_new == 0`` keeps its state bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.schemes import linear_apply, linear_init
from .common import rmsnorm, rmsnorm_init


def _buffers(module: nn.Module, **tensors) -> nn.Module:
    for name, t in tensors.items():
        module.register_buffer(name, t)
    return module


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    ssm_state: int = 64          # N
    head_dim: int = 64           # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_state


class Mamba2Params(nn.Module):
    """One Mamba2 mixer: linears ``in_proj [d, 2 d_inner + 2 N + H]`` and
    ``out_proj [d_inner, d]``, ``norm`` (RMSNorm over d_inner), buffers
    ``conv_w [W, conv_dim]``, ``conv_b``, ``dt_bias [H]``, ``a_log [H]``
    (A = -exp(a_log)) and ``d_skip [H]``."""

    def __init__(self, in_proj, out_proj, norm, **fp):
        super().__init__()
        self.in_proj, self.out_proj, self.norm = in_proj, out_proj, norm
        _buffers(self, **fp)


def mamba2_init(generator, cfg: Mamba2Config, pol,
                device="cuda") -> Mamba2Params:
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_heads  # z,x,B,C,dt
    in_proj = linear_init(generator, cfg.d_model, d_in_proj, pol.at("in_proj"),
                          device)
    out_proj = linear_init(generator, cfg.d_inner, cfg.d_model,
                           pol.at("out_proj"), device)
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2Params(
        in_proj, out_proj, rmsnorm_init(cfg.d_inner, device=device),
        conv_w=torch.randn((cfg.conv_width, cfg.conv_dim),
                           generator=generator, **f32) * 0.1,
        conv_b=torch.zeros((cfg.conv_dim,), **f32),
        dt_bias=torch.zeros((cfg.n_heads,), **f32),
        a_log=torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, **f32)),
        d_skip=torch.ones((cfg.n_heads,), **f32))


def _split_in_proj(h, cfg: Mamba2Config):
    di, dc = cfg.d_inner, cfg.d_inner + cfg.conv_dim
    return h[..., :di], h[..., di:dc], h[..., dc:]


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, xbc: [B, S, C], w: [W, C] (f32 out)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b[None, None, :])


def _ssd_chunk(h0, xs, cfg: Mamba2Config):
    """One SSD chunk. h0: [B, H, P, N]; xs = (u, bmat, cmat, loga) with
    u: [B, Q, H, P], bmat / cmat: [B, Q, N], loga: [B, Q, H]."""
    u, bmat, cmat, loga = xs
    l = torch.cumsum(loga, dim=1)  # [B, Q, H] inclusive
    # intra-chunk: G[b, i, j, h] = (C_i . B_j) exp(l_i - l_j) [i >= j]
    cb = torch.einsum("bin,bjn->bij", cmat, bmat)
    ldiff = l[:, :, None, :] - l[:, None, :, :]  # [B, Q, Q, H]
    q = loga.shape[1]
    causal = torch.ones((q, q), dtype=torch.bool, device=loga.device).tril()
    # the exponent is masked BEFORE exp: the i < j entries are positive and
    # overflow to inf, and where(mask, exp(inf), 0) back-propagates NaN
    ldiff = torch.where(causal[None, :, :, None], ldiff, -1e30)
    g = torch.exp(ldiff) * cb[..., None]
    y = torch.einsum("bijh,bjhp->bihp", g, u)
    # inter-chunk: C_i . (exp(l_i) h0)
    y = y + torch.einsum("bin,bhpn,bih->bihp", cmat, h0, torch.exp(l))
    decay = torch.exp(l[:, -1:, :] - l)  # [B, Q, H] (= prod_{j<t<=Q} a)
    h_new = h0 * torch.exp(l[:, -1])[:, :, None, None] + torch.einsum(
        "bjhp,bjn,bjh->bhpn", u, bmat, decay)
    return h_new, y


def mamba2_mix(p: Mamba2Params, x, cfg: Mamba2Config, return_state=False):
    """Training / prefill path. x: [B, S, d] -> [B, S, d] (and with
    ``return_state`` the decode state after the last position)."""
    b, s, _ = x.shape
    h = linear_apply(p.in_proj, x)
    z, xbc_raw, dt_raw = _split_in_proj(h, cfg)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    di, n = cfg.d_inner, cfg.ssm_state
    xin, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)  # [B, S, H]
    loga = dt * (-torch.exp(p.a_log))[None, None, :]  # log decay, <= 0
    xh = xin.reshape(b, s, cfg.n_heads, cfg.head_dim).to(torch.float32)
    u = xh * dt[..., None]
    qch = min(cfg.chunk, s)
    if s % qch:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qch}")
    state = torch.zeros((b, cfg.n_heads, cfg.head_dim, n),
                        dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, s, qch):
        sl = slice(i, i + qch)
        state, y_ = _ssd_chunk(state, (u[:, sl], bmat[:, sl].float(),
                                       cmat[:, sl].float(), loga[:, sl]), cfg)
        ys.append(y_.to(x.dtype))  # the chunk outputs in the activation dtype
    y = torch.cat(ys, dim=1)
    y = y.to(torch.float32) + xh * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(p.norm, y) * F.silu(z)
    out = linear_apply(p.out_proj, y)
    if return_state:
        return out, {"conv": xbc_raw[:, -(cfg.conv_width - 1):, :].to(
            torch.float32), "ssm": state}
    return out


def mamba2_chunk_step(p: Mamba2Params, x, state, n_new, cfg: Mamba2Config):
    """Ragged chunk step: x [B, C, d]; slot b consumes rows [:n_new[b]],
    advancing its (conv, ssm) recurrence by exactly n_new[b] tokens.
    Masked rows are identity in the recurrence (loga = 0, u = 0), so a slot
    with n_new == 0 keeps its state bit for bit; their outputs are garbage
    (never read).  Returns (out, new state)."""
    b, c, _ = x.shape
    n_new = n_new.to(torch.int64)
    valid = torch.arange(c, device=x.device)[None, :] < n_new[:, None]
    h = linear_apply(p.in_proj, x)
    z, xbc, dt_raw = _split_in_proj(h, cfg)
    # depthwise causal conv over [carried window | chunk]: output row i
    # sees cat positions i..i+W-1
    width = cfg.conv_width
    cat = torch.cat([state["conv"].to(torch.float32),
                     xbc.to(torch.float32)], dim=1)   # [B, W-1+C, Cv]
    conv = sum(cat[:, i:i + c, :] * p.conv_w[i][None, None, :]
               for i in range(width))
    conv = F.silu(conv + p.conv_b[None, None, :])
    di, n = cfg.d_inner, cfg.ssm_state
    xin, bmat, cmat = conv[..., :di], conv[..., di:di + n], conv[..., di + n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)  # [B, C, H]
    loga = dt * (-torch.exp(p.a_log))[None, None, :]
    loga = torch.where(valid[..., None], loga, 0.0)        # masked: decay 1
    xh = xin.reshape(b, c, cfg.n_heads, cfg.head_dim)
    u = xh * dt[..., None]
    u = torch.where(valid[..., None, None], u, 0.0)        # masked: no input
    ssm, y = _ssd_chunk(state["ssm"].to(torch.float32),
                        (u, bmat, cmat, loga), cfg)
    y = y + xh * p.d_skip[None, None, :, None]
    y = y.reshape(b, c, di).to(x.dtype)
    y = rmsnorm(p.norm, y) * F.silu(z)
    out = linear_apply(p.out_proj, y)
    # the new window: the last W-1 valid inputs, cat positions
    # n_new[b]..n_new[b]+W-2 (n_new == 0 keeps the old window verbatim)
    idx = n_new[:, None] + torch.arange(width - 1, device=x.device)[None, :]
    new_conv = torch.gather(cat, 1, idx[..., None].expand(-1, -1,
                                                          cat.shape[2]))
    return out, {"conv": new_conv, "ssm": ssm}


def mamba2_init_state(batch: int, cfg: Mamba2Config, dtype=torch.float32,
                      device="cuda"):
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.ssm_state),
                           dtype=dtype, device=device)}


def mamba2_decode(p: Mamba2Params, x, state, cfg: Mamba2Config):
    """Single-token step. x: [B, 1, d]."""
    b = x.shape[0]
    h = linear_apply(p.in_proj, x)[:, 0]
    z, xbc, dt_raw = _split_in_proj(h, cfg)
    window = torch.cat([state["conv"], xbc[:, None, :].to(
        state["conv"].dtype)], dim=1)  # [B, W, C]
    conv = F.silu(torch.einsum("bwc,wc->bc", window.to(torch.float32),
                               p.conv_w) + p.conv_b)
    di, n = cfg.d_inner, cfg.ssm_state
    xin, bvec, cvec = conv[..., :di], conv[..., di:di + n], conv[..., di + n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)  # [B, H]
    a = torch.exp(dt * (-torch.exp(p.a_log))[None, :])
    xh = xin.reshape(b, cfg.n_heads, cfg.head_dim)
    u = xh * dt[..., None]
    ssm = state["ssm"] * a[..., None, None] + torch.einsum("bhp,bn->bhpn",
                                                           u, bvec)
    y = torch.einsum("bhpn,bn->bhp", ssm, cvec) \
        + xh * p.d_skip[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(p.norm, y) * F.silu(z)
    out = linear_apply(p.out_proj, y[:, None, :])
    return out, {"conv": window[:, 1:], "ssm": ssm}


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


class RWKV6Params(nn.Module):
    """One RWKV6 block's mixers: the time mix's linears ``wr wk wv wg wo``
    ([d, d]) and the channel mix's ``ck [d, d_ff]``, ``cv [d_ff, d]``,
    ``cr [d, d]``; ``ln_x`` (RMSNorm over d); buffers ``mu [5, d]`` (the
    r, k, v, g, w token-shift mixes), ``w0 [d]``, the decay LoRA ``w1 [d,
    decay_lora]`` and ``w2``, the bonus ``u [H, hd]`` and ``cmu [2, d]``."""

    LINEARS = ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr")

    def __init__(self, linears: dict, ln_x, **fp):
        super().__init__()
        for name in self.LINEARS:
            setattr(self, name, linears[name])
        self.ln_x = ln_x
        _buffers(self, **fp)


def rwkv6_init(generator, cfg: RWKV6Config, pol,
               device="cuda") -> RWKV6Params:
    d = cfg.d_model
    dims = {"wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
            "wo": (d, d), "ck": (d, cfg.d_ff), "cv": (cfg.d_ff, d),
            "cr": (d, d)}
    linears = {name: linear_init(generator, *dims[name], pol.at(name), device)
               for name in RWKV6Params.LINEARS}
    f32 = dict(dtype=torch.float32, device=device)

    def randn(shape, scale):
        return torch.randn(shape, generator=generator, **f32) * scale
    return RWKV6Params(
        linears, rmsnorm_init(d, device=device),
        mu=0.5 * torch.ones((5, d), **f32),
        w0=torch.full((d,), -6.0, **f32),
        w1=randn((d, cfg.decay_lora), 0.02),
        w2=randn((cfg.decay_lora, d), 0.02),
        u=randn((cfg.n_heads, cfg.head_dim), 0.1),
        cmu=0.5 * torch.ones((2, d), **f32))


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros, or ``prev``, for t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


# exp(-lw) overflows once a chunk's cumulative decay passes ~e^-30; those
# contributions are 0 anyway, so the factored exponentials are clamped
_WKV_CLAMP = -30.0


def _wkv_chunk(s0, xs, u):
    """One WKV chunk. s0: [B, H, K, V]; xs = (r, k, v, logw): [B, Q, H,
    K/V]; ``u`` [H, K] the bonus of the current token."""
    r, k, v, logw = xs
    lw = torch.cumsum(logw, dim=1)  # [B, Q, H, K] inclusive
    lw_ex = lw - logw               # exclusive: the decay before position t
    lw_safe = torch.clamp(lw, min=_WKV_CLAMP)
    r_t = r * torch.exp(torch.clamp(lw_ex, min=_WKV_CLAMP))
    k_t = k * torch.exp(-lw_safe)
    att = torch.einsum("bihk,bjhk->bhij", r_t, k_t)  # strict-causal i > j
    q = r.shape[1]
    strict = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(strict[None, None], att, 0.0)
    y = torch.einsum("bhij,bjhv->bihv", att, v)
    # the current token through the bonus u
    y = y + torch.einsum("bihk,hk,bihk,bihv->bihv", r, u, k, v)
    # the carried state
    y = y + torch.einsum("bihk,bhkv->bihv", r_t, s0)
    # S' = diag(prod w) S + sum_j diag(prod_{t>j} w) k_j v_j
    total = lw[:, -1]  # [B, H, K]
    decay_after = torch.exp(total[:, None] - lw)
    s_new = s0 * torch.exp(total)[..., None] + torch.einsum(
        "bjhk,bjhv->bhkv", k * decay_after, v)
    return s_new, y


def _rkvgw(p: RWKV6Params, x, xp, cfg: RWKV6Config):
    """The time mix's projections of the token-shift mixes of x and xp:
    r, k, v as f32 [B, S, H, hd], the gate g, and the log decay logw."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def mix(i):
        return x + p.mu[i][None, None, :].to(x.dtype) * (xp - x)

    def heads(name, i):
        return linear_apply(getattr(p, name), mix(i)).reshape(
            b, s, h, hd).to(torch.float32)
    r, k, v = heads("wr", 0), heads("wk", 1), heads("wv", 2)
    g = linear_apply(p.wg, mix(3))
    # the data-dependent decay (the Finch hallmark)
    wx = mix(4).to(torch.float32)
    dec = p.w0 + torch.tanh(wx @ p.w1) @ p.w2
    logw = -torch.exp(dec).reshape(b, s, h, hd)  # log w_t < 0
    return r, k, v, g, logw


def rwkv6_time_mix(p: RWKV6Params, x, cfg: RWKV6Config, prev=None,
                   state=None):
    """x: [B, S, d]; returns (y, (last x, new WKV state))."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    r, k, v, g, logw = _rkvgw(p, x, _shift(x, prev), cfg)
    qch = min(cfg.chunk, s)
    if s % qch:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qch}")
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state.to(torch.float32))
    ys = []
    for i in range(0, s, qch):
        sl = slice(i, i + qch)
        st, y_ = _wkv_chunk(st, (r[:, sl], k[:, sl], v[:, sl], logw[:, sl]),
                            p.u)
        ys.append(y_.to(x.dtype))  # the chunk outputs in the activation dtype
    y = torch.cat(ys, dim=1).reshape(b, s, d)
    y = rmsnorm(p.ln_x, y) * F.silu(g)
    return linear_apply(p.wo, y), (x[:, -1:], st)


def rwkv6_channel_mix(p: RWKV6Params, x, cfg: RWKV6Config, prev=None):
    xp = _shift(x, prev)
    mixk = x + p.cmu[0][None, None, :].to(x.dtype) * (xp - x)
    mixr = x + p.cmu[1][None, None, :].to(x.dtype) * (xp - x)
    k = torch.square(F.relu(linear_apply(p.ck, mixk)))
    v = linear_apply(p.cv, k)
    return torch.sigmoid(linear_apply(p.cr, mixr)) * v, x[:, -1:]


def rwkv6_decode_time_mix(p: RWKV6Params, x, state, cfg: RWKV6Config):
    """Single token: x [B, 1, d]; state = (prev x [B, 1, d], S [B, H, K,
    V])."""
    prev, s0 = state
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    r, k, v, g, logw = _rkvgw(p, x, prev, cfg)
    r, k, v = (t.reshape(b, h, hd) for t in (r, k, v))
    w = torch.exp(logw).reshape(b, h, hd)
    # y_t = r . (S + diag(u) k v^T)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    s0 = s0.to(torch.float32)
    y = torch.einsum("bhk,bhkv->bhv", r, s0 + p.u[None, ..., None] * kv)
    s_new = s0 * w[..., None] + kv
    y = y.reshape(b, 1, -1).to(x.dtype)
    y = rmsnorm(p.ln_x, y) * F.silu(g)
    return linear_apply(p.wo, y), (x, s_new)


def _ragged_prev(prev, x, n_new):
    """The token-shift carry after a ragged chunk: row x[b, n_new[b] - 1]
    (the last valid row), or the old ``prev`` when n_new[b] == 0."""
    cat = torch.cat([prev.to(x.dtype), x], dim=1)  # [B, 1 + C, d]
    idx = n_new.to(torch.int64)[:, None, None].expand(-1, 1, x.shape[2])
    return torch.gather(cat, 1, idx)


def rwkv6_time_mix_ragged(p: RWKV6Params, x, state, n_new,
                          cfg: RWKV6Config):
    """Ragged chunk time mix: x [B, C, d]; slot b consumes rows
    [:n_new[b]], advancing its (prev x, WKV) state by exactly n_new[b]
    tokens.  Masked rows are identity in the recurrence (logw = 0, k = 0),
    so a slot with n_new == 0 keeps its state bit for bit; their outputs
    are garbage (never read)."""
    prev, s0 = state
    b, c, d = x.shape
    valid = torch.arange(c, device=x.device)[None, :] < n_new[:, None]
    r, k, v, g, logw = _rkvgw(p, x, _shift(x, prev.to(x.dtype)), cfg)
    logw = torch.where(valid[..., None, None], logw, 0.0)  # masked: decay 1
    k = torch.where(valid[..., None, None], k, 0.0)        # masked: no kv
    s_new, y = _wkv_chunk(s0.to(torch.float32), (r, k, v, logw), p.u)
    y = y.reshape(b, c, d).to(x.dtype)
    y = rmsnorm(p.ln_x, y) * F.silu(g)
    return linear_apply(p.wo, y), (_ragged_prev(prev, x, n_new), s_new)


def rwkv6_channel_mix_ragged(p: RWKV6Params, x, prev, n_new,
                             cfg: RWKV6Config):
    """Ragged chunk channel mix: its only state is the token-shift carry,
    so the math is :func:`rwkv6_channel_mix`'s; the carry advances by each
    slot's own n_new."""
    out, _ = rwkv6_channel_mix(p, x, cfg, prev=prev.to(x.dtype))
    return out, _ragged_prev(prev, x, n_new)


def rwkv6_init_state(batch: int, cfg: RWKV6Config, dtype=torch.float32,
                     device="cuda"):
    # the token-shift carries live in the activation dtype (they mix with
    # x); the WKV state accumulates in f32
    return {
        "tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device)}

