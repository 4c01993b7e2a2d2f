"""State-space blocks, port of ``repro.models.ssm``: Mamba2 (SSD,
chunkwise-parallel) and xLSTM (the mLSTM's chunkwise matrix memory and the
sLSTM's recurrence).

Both forwards use the chunkwise formulation of the reference: dense masked
products inside a chunk, a recurrence over the S / chunk chunks (a Python
loop here, ``lax.scan`` there). The sLSTM has recurrent weights and stays a
loop over time, one step a token. The decode steps carry the recurrent
state in f32 and update the caller's cache tensors IN PLACE (the reference
returns new ones). Every explicit bf16 cast of the reference is kept, also
where the weights are f32: Mamba2's ``dt``, the chunked scan's compute type
(that of v), the sLSTM's hidden state and the mLSTM's output.

The reference's own deviations stay (its DESIGN.md): bounded sigmoid gates
in place of xLSTM's exponential input gate and stabiliser, and a qk head
dim of half the v head dim.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    DTYPE, Dense, Init, _param, batch_sharded, constrain, einsum, matmul,
    rmsnorm, shardwise, split_heads)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

MAMBA_HEADDIM = 64
MAMBA_CONV = 4


def mamba_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // MAMBA_HEADDIM
    return d_inner, n_heads, cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, in_proj: Dense, conv_w, A_log, dt_bias, D, gate_norm,
                 out_proj: Dense):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        self.conv_w, self.A_log = _param(conv_w), _param(A_log)
        self.dt_bias, self.D = _param(dt_bias), _param(D)
        self.gate_norm = _param(gate_norm)


def init_mamba2(cfg: ArchConfig, ini: Init) -> Mamba2:
    d, (d_inner, h, n) = cfg.d_model, mamba_dims(cfg)
    return Mamba2(
        in_proj=ini.dense(d, 2 * d_inner + 2 * n + h),
        conv_w=ini.normal((MAMBA_CONV, d_inner + 2 * n), 0.5),
        A_log=ini.zeros(h),
        dt_bias=ini.zeros(h),
        D=ini.ones(h),
        gate_norm=ini.ones(d_inner),
        out_proj=ini.dense(d_inner, d),
    )


def _causal_conv(x, w):
    """Depthwise causal conv, x (B,S,C), w (K,C)."""
    k = w.shape[0]
    xp = shardwise(lambda t: F.pad(t, (0, 0, k - 1, 0)), x, (1,))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def chunked_linear_attention(q, k, v, decay, chunk):
    """Chunkwise gated linear attention / SSD (Mamba-2 arXiv:2405.21060 §6):

        S_t = a_t * S_{t-1} + k_t v_t^T ;   y_t = q_t . S_t

    q/k: (B,S,N) shared across heads (SSD's B/C) or (B,S,H,N) per head
    (mLSTM); v: (B,S,H,P); decay: (B,S,H) in (0,1]. Returns (B,S,H,P) in
    v's type, which is the compute type of the products (``cdtype``).

    Inside a chunk: dense masked products; across chunks: a loop over the
    S / chunk chunk states."""
    b, s, h, p = v.shape
    per_head = q.dim() == 4
    n = q.shape[-1]
    nc = s // chunk
    vc = v.reshape(b, nc, chunk, h, p)
    a = decay.reshape(b, nc, chunk, h).float()
    qc = q.reshape((b, nc, chunk, h, n) if per_head else (b, nc, chunk, n))
    kc = k.reshape((b, nc, chunk, h, n) if per_head else (b, nc, chunk, n))

    log_a = torch.log(a.clamp_min(1e-20))
    cum = torch.cumsum(log_a, dim=2)                      # (b,nc,L,h)

    # intra-chunk: M[i,j,h] = q_i.k_j * exp(cum_i - cum_j), j <= i
    if per_head:
        scores = einsum("bcihn,bcjhn->bcijh", qc, kc)
    else:
        scores = einsum("bcin,bcjn->bcij", qc, kc)[..., None]
    pair = torch.exp(
        (cum[:, :, :, None, :] - cum[:, :, None, :, :]).clamp(-60.0, 0.0))
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=v.device).tril()[None, None, :, :, None]
    cdtype = vc.dtype
    # pair * scores * mask, out of place on pair (exp's saved output)
    w = (pair * scores).mul_(mask).to(cdtype)
    y_intra = einsum("bcijh,bcjhp->bcihp", w, vc)

    # per-chunk outgoing state: S_c = sum_j exp(cum_L - cum_j) k_j v_j^T
    tail = torch.exp((cum[:, :, -1:, :] - cum).clamp(-60.0, 0.0)).to(cdtype)
    if per_head:
        states = einsum("bcjhn,bcjh,bcjhp->bchnp", kc, tail, vc)
    else:
        states = einsum("bcjn,bcjh,bcjhp->bchnp", kc, tail, vc)

    # inter-chunk recurrence, sequential over nc: the state BEFORE each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :].clamp(-60.0, 0.0)).to(cdtype)
    carry = torch.zeros((b, h, n, p), dtype=cdtype, device=v.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = (carry * chunk_decay[:, c, :, None, None]
                 + states[:, c]).to(cdtype)
    prev_states = torch.stack(prev, dim=1)                # (b,nc,h,n,p)

    into = torch.exp(cum.clamp(-60.0, 0.0)).to(cdtype)
    if per_head:
        y_inter = einsum("bcihn,bcih,bchnp->bcihp", qc, into, prev_states)
    else:
        y_inter = einsum("bcin,bcih,bchnp->bcihp", qc, into, prev_states)
    return (y_intra + y_inter).reshape(b, s, h, p)


def _mamba_split(cfg: ArchConfig, zxbcdt):
    d_inner, h, n = mamba_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)


def _mamba_dt(p: Mamba2, dt):
    """softplus(dt + bias) and the decay exp(A dt), f32."""
    dt = F.softplus(dt.float() + p.dt_bias.float())
    a = torch.exp(-torch.exp(p.A_log.float()) * dt)
    return dt, a


def mamba2_forward(cfg: ArchConfig, p: Mamba2, x):
    """x (B,S,d) -> (B,S,d)."""
    b, s, _ = x.shape
    d_inner, h, n = mamba_dims(cfg)
    # column-parallel, in the forward and (as a redistribution's backward)
    # in the gradient (a no-op outside the dry run)
    zxbcdt = constrain(matmul(x, p.in_proj.w), "dp", None, "tp")
    z, xin, Bc, Cc, dt = _mamba_split(cfg, zxbcdt)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt, a = _mamba_dt(p, dt)                              # (B,S,H) decay
    xh = (xin * dt.repeat_interleave(MAMBA_HEADDIM, dim=-1).to(DTYPE)
          ).reshape(b, s, h, MAMBA_HEADDIM)
    y = chunked_linear_attention(Cc, Bc, xh, a, cfg.ssm_chunk)
    y = y + xh * p.D[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    # the gate and the row-parallel output projection's input: inner
    # channels over the tensor axis (a no-op outside the dry run)
    z = constrain(z, "dp", None, "tp")
    y = constrain(rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps),
                  "dp", None, "tp")
    return matmul(y, p.out_proj.w)


def mamba2_decode(cfg: ArchConfig, p: Mamba2, x, state, conv_state):
    """One-token decode. state (B,H,N,P) f32; conv_state (B,K-1,C) in the
    promoted type of bf16 and the weights' (the reference's bf16 cache
    takes that type at its first step); both updated in place. Returns
    ``(out (B,1,d), state, conv_state)``."""
    b = x.shape[0]
    d_inner, h, n = mamba_dims(cfg)
    z, xin, Bc, Cc, dt = _mamba_split(cfg, matmul(x[:, 0], p.in_proj.w))
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)            # (B,C)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)   # (B,K,C)
    conv_out = F.silu(einsum("bkc,kc->bc", window, p.conv_w))
    conv_state.copy_(window[:, 1:])
    xin, Bc, Cc = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt, a = _mamba_dt(p, dt)                              # (B,H)
    xh = (xin * dt.repeat_interleave(MAMBA_HEADDIM, dim=-1).to(DTYPE)
          ).reshape(b, h, MAMBA_HEADDIM)
    state.mul_(a[:, :, None, None]).add_(
        torch.einsum("bn,bhp->bhnp", Bc.float(), xh.float()))
    y = torch.einsum("bn,bhnp->bhp", Cc.float(), state).to(DTYPE)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(b, d_inner)
    y = rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    return matmul(y, p.out_proj.w)[:, None], state, conv_state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar recurrent)
# ---------------------------------------------------------------------------

def xlstm_dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model
    h = cfg.n_heads
    dv = d_inner // h
    dqk = dv // 2
    return d_inner, h, dqk, dv


class MLSTM(nn.Module):
    def __init__(self, up_proj, wq, wk, wv, w_gates, out_norm, down_proj):
        super().__init__()
        self.up_proj, self.wq, self.wk, self.wv = up_proj, wq, wk, wv
        self.w_gates, self.down_proj = w_gates, down_proj
        self.out_norm = _param(out_norm)


def init_mlstm(cfg: ArchConfig, ini: Init) -> MLSTM:
    d, (d_inner, h, dqk, dv) = cfg.d_model, xlstm_dims(cfg)
    return MLSTM(
        up_proj=ini.dense(d, 2 * d_inner),
        wq=ini.dense(d_inner, h * dqk),
        wk=ini.dense(d_inner, h * dqk),
        wv=ini.dense(d_inner, h * dv),
        w_gates=ini.dense(d_inner, 2 * h, scale=0.02),
        out_norm=ini.ones(d_inner),
        down_proj=ini.dense(d_inner, d),
    )


def _mlstm_inputs(cfg: ArchConfig, p: MLSTM, x):
    """q (scaled), k, v, the forget and input gates (f32) and z, for x
    (..., d) with the heads split out of the last dimension."""
    d_inner, h, dqk, dv = xlstm_dims(cfg)
    lead = x.shape[:-1]
    u, z = matmul(x, p.up_proj.w).chunk(2, dim=-1)
    q = split_heads(matmul(u, p.wq.w), h, *lead, h, dqk) * dqk ** -0.5
    k = split_heads(matmul(u, p.wk.w), h, *lead, h, dqk)
    v = split_heads(matmul(u, p.wv.w), h, *lead, h, dv)
    gates = matmul(u, p.w_gates.w)
    f = torch.sigmoid(gates[..., :h].float() + 4.0)       # forget
    i = torch.sigmoid(gates[..., h:].float())             # input
    return q, k, v, f, i, z


def mlstm_forward(cfg: ArchConfig, p: MLSTM, x):
    """Chunkwise mLSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T; y_t = C_t q_t."""
    b, s, _ = x.shape
    d_inner, h, dqk, dv = xlstm_dims(cfg)
    q, k, v, f, i, z = _mlstm_inputs(cfg, p, x)
    # the normaliser rides along as a column of ones appended to v, so one
    # pass gives the numerator (dv columns) and q.n_t (the last)
    iv = i[..., None].to(DTYPE)
    v_aug = torch.cat([v * iv, iv.expand(b, s, h, 1)], dim=-1)
    out = chunked_linear_attention(q, k, v_aug, f, cfg.ssm_chunk)
    num, qn = out[..., :dv], out[..., dv]
    den = qn.float().abs().clamp_min(1.0)
    y = (num.float() / den[..., None]).to(DTYPE).reshape(b, s, d_inner)
    y = rmsnorm(y, p.out_norm, cfg.norm_eps) * F.silu(z)
    return matmul(y, p.down_proj.w)


def mlstm_decode(cfg: ArchConfig, p: MLSTM, x, C, norm_n):
    """One-token mLSTM decode; C (B,H,dqk,dv) f32 and norm_n (B,H,dqk) f32,
    both updated in place. Returns ``(out (B,1,d), C, norm_n)``."""
    b = x.shape[0]
    d_inner, h, dqk, dv = xlstm_dims(cfg)
    q, k, v, f, i, z = _mlstm_inputs(cfg, p, x[:, 0])
    C.mul_(f[..., None, None]).add_(i[..., None, None] * torch.einsum(
        "bhk,bhv->bhkv", k.float(), v.float()))
    norm_n.mul_(f[..., None]).add_(i[..., None] * k.float())
    num = torch.einsum("bhk,bhkv->bhv", q.float(), C)
    den = torch.einsum("bhk,bhk->bh", q.float(), norm_n).abs().clamp_min(1.0)
    y = batch_sharded((num / den[..., None]).to(DTYPE)).reshape(b, d_inner)
    y = rmsnorm(y, p.out_norm, cfg.norm_eps) * F.silu(z)
    return matmul(y, p.down_proj.w)[:, None], C, norm_n


class SLSTM(nn.Module):
    def __init__(self, w_in: Dense, r, out_norm, proj: Dense):
        super().__init__()
        self.w_in, self.proj = w_in, proj
        self.r, self.out_norm = _param(r), _param(out_norm)


def init_slstm(cfg: ArchConfig, ini: Init) -> SLSTM:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return SLSTM(
        w_in=ini.dense(d, 4 * d),                         # i,f,z,o
        r=ini.normal((h, dh, 4 * dh), dh ** -0.5),        # block-diagonal
        out_norm=ini.ones(d),
        proj=ini.dense(d, d),
    )


def _slstm_cell(r, pre, c, hidden):
    """One step: r (h,dh,4dh) the recurrent weights, pre (B,h,4dh) input
    pre-activations, c (B,h,dh) f32, hidden (B,h,dh) bf16 -> the new (c,
    hidden)."""
    rec = einsum("bhd,hdk->bhk", hidden, r)
    ig, fg, zg, og = (pre + rec).float().chunk(4, dim=-1)
    c = torch.sigmoid(fg + 4.0) * c + torch.sigmoid(ig) * torch.tanh(zg)
    hidden = (torch.sigmoid(og) * torch.tanh(c)).to(DTYPE)
    return c, hidden


def slstm_forward(cfg: ArchConfig, p: SLSTM, x):
    """sLSTM: scalar-memory LSTM with head-blocked recurrent weights, a
    loop over the S time steps (the reference's ``lax.scan``)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    pre_all = split_heads(matmul(x, p.w_in.w), h, b, s, h, 4 * dh)
    ys = _slstm_scan(pre_all, p.r)
    y = rmsnorm(ys.reshape(b, s, d), p.out_norm, cfg.norm_eps)
    return matmul(y, p.proj.w)


def _slstm_scan(pre_all, r):
    """The time loop: pre_all (B,S,h,4dh) -> the hidden states (B,S,h,dh)
    from zero states."""
    b, s, h, _ = pre_all.shape
    dh = r.shape[1]
    c = torch.zeros((b, h, dh), dtype=torch.float32, device=pre_all.device)
    hidden = torch.zeros((b, h, dh), dtype=DTYPE, device=pre_all.device)
    ys = []
    for t in range(s):
        c, hidden = _slstm_cell(r, pre_all[:, t], c, hidden)
        ys.append(hidden)
    return torch.stack(ys, dim=1)


def slstm_decode(cfg: ArchConfig, p: SLSTM, x, c, hidden):
    """One step; c (B,h,dh) f32 and hidden (B,h,dh) bf16, both updated in
    place. Returns ``(out (B,1,d), c, hidden)``."""
    b = x.shape[0]
    h = cfg.n_heads
    dh = cfg.d_model // h
    pre = split_heads(matmul(x[:, 0], p.w_in.w), h, b, h, 4 * dh)
    c2, h2 = _slstm_cell(p.r, pre, c, hidden)
    c.copy_(c2)
    hidden.copy_(h2)
    y = rmsnorm(batch_sharded(hidden).reshape(b, cfg.d_model), p.out_norm,
                cfg.norm_eps)
    return matmul(y, p.proj.w)[:, None], c, hidden
