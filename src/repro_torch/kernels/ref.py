"""Plain PyTorch versions of the kernels: what the CPU path runs, and what the
CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def attention_ref(q, k, v, *, causal: bool = True, group_size: int = 1):
    """Naive attention oracle (port of the JAX package's ``kernels/ref.py``).
    q (B,Hq,S,D); k,v (B,Hkv,T,D); causal mask aligned bottom-right."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    if group_size > 1:
        k = k.repeat_interleave(group_size, dim=1)
        v = v.repeat_interleave(group_size, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def chunked_attention_ref(
    q, k, v, *, causal: bool, chunk: int, q_offset: int = 0,
    kv_len: Optional[int] = None,
):
    """Online-softmax attention over kv chunks, step for step as the JAX
    package's ``models/attention.py::chunked_attention``.

    q: (B,S,KR,Gl,D); k,v: (B,T,KR,D).  Rounding points: q is scaled and
    rounded to its dtype (the scale itself rounded to that dtype first, as a
    weak-typed Python scalar is in JAX), scores and sums are float32, p is
    rounded to the kv dtype before the PV product, and the output is rounded
    to q's dtype once.
    """
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=q.device)
    chunk = min(chunk, T)
    if T % chunk:  # pad kv to a chunk multiple; §4.1 pad-and-mask
        padded = -(-T // chunk) * chunk
        k = F.pad(k, (0, 0, 0, 0, 0, padded - T))
        v = F.pad(v, (0, 0, 0, 0, 0, padded - T))
        kv_len = min(kv_len, T) if kv_len is not None else T
        T = padded
    qf = (q * scale).to(q.dtype).float()
    q_pos = q_offset + torch.arange(S, device=q.device)

    acc = torch.zeros((B, S, KR, Gl, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, S, KR, Gl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, KR, Gl), dtype=torch.float32, device=q.device)
    for idx in range(T // chunk):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        s = torch.einsum("bsngd,btnd->bsngt", qf, kb.float())
        k_pos = idx * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((S, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsngt,btnd->bsngd", p.to(kb.dtype).float(), vb.float()
        )
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    return out.to(q.dtype)


def flash_decode_partial_ref(q, k, v, pos, chunk: int):
    """A decode step's attention at one position per batch row, with each
    row's log-sum-exp: what the kernel's decode computes for a
    sequence-sharded cache's fold.  q (B,S,KR,Gl,D) at position ``pos``
    (int (B,), possibly negative: keys below pos + 1 visible, no causal
    mask), k/v (B,T,KR,D).  The online softmax of ``chunked_attention_ref``
    with a per-row key mask, and a masked key's p set to 0, so that a row
    that sees no key gives output 0 and log-sum-exp -1e9 (a row that sees
    one gives what ``chunked_attention_ref`` at q_offset pos, kv_len pos + 1
    gives).  Returns (out in q's dtype, lse float32 (B, KR, S * Gl))."""
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=q.device)
    chunk = min(chunk, T)
    if T % chunk:
        padded = -(-T // chunk) * chunk
        k = F.pad(k, (0, 0, 0, 0, 0, padded - T))
        v = F.pad(v, (0, 0, 0, 0, 0, padded - T))
    qf = (q * scale).to(q.dtype).float()
    stop = (pos.long() + 1).clamp_max(T).reshape(B, 1)
    acc = torch.zeros((B, S, KR, Gl, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, S, KR, Gl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, KR, Gl), dtype=torch.float32, device=q.device)
    for idx in range(k.shape[1] // chunk):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        s = torch.einsum("bsngd,btnd->bsngt", qf, kb.float())
        k_pos = idx * chunk + torch.arange(chunk, device=q.device)
        mask = (k_pos[None, :] < stop)[:, None, None, None, :]  # (B,1,1,1,chunk)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsngt,btnd->bsngd", p.to(kb.dtype).float(), vb.float())
        m = m_new
    out = (acc / torch.clamp_min(l[..., None], 1e-20)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))
    return out, lse.permute(0, 2, 1, 3).reshape(B, KR, S * Gl)


def attention_lse_ref(q, k, *, causal: bool):
    """Each q row's log-sum-exp of its scaled, masked scores in float32, as
    the forward kernel writes it for the backward: (B, KR, S * Gl), row
    r = s * Gl + g; the causal mask aligned top-left (q_offset = 0)."""
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=q.device)
    qf = (q * scale).to(q.dtype).float()
    s = torch.einsum("bsngd,btnd->bnsgt", qf, k.float())
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)
        s = torch.where(mask[None, None, :, None, :], s, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, dim=-1).reshape(B, KR, S * Gl)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool):
    """The backward kernel's formulas in plain PyTorch: (dq, dk, dv) of
    attention with q (B,S,KR,Gl,D), k/v (B,T,KR,D), from the forward's
    output ``out`` and log-sum-exp ``lse`` (B, KR, S * Gl) and the output's
    gradient ``do``.  qf = round(q * scale); P = exp(qf K^T - lse), masked
    (causal top-left, q_offset = 0); Delta = rowsum(do * out); dS = P * (dP -
    Delta) with dP = do V^T, all float32.  P is rounded to the kv dtype
    before its product with do, dS to q's dtype before its products with K
    and qf (as the kernel's bf16 operands), and dq = scale * dS K is rounded
    once."""
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=q.device)
    qf = (q * scale).to(q.dtype).float()
    s = torch.einsum("bsngd,btnd->bsngt", qf, k.float())
    lse = lse.reshape(B, KR, S, Gl).permute(0, 2, 1, 3)
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)
        p = torch.where(mask[None, :, None, None, :], p, torch.zeros_like(p))
    delta = (do.float() * out.float()).sum(dim=-1)
    dp = torch.einsum("bsngd,btnd->bsngt", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = (torch.einsum("bsngt,btnd->bsngd", ds, k.float()) * scale.float()).to(q.dtype)
    dk = torch.einsum("bsngt,bsngd->btnd", ds, qf).to(k.dtype)
    dv = torch.einsum("bsngt,bsngd->btnd", p.to(v.dtype).float(), do.float()).to(v.dtype)
    return dq, dk, dv


def ssd_scan_ref(x, dt, B, C, A, chunk: int):
    """Chunked SSD, step for step as the JAX package's
    ``models/ssm.py::ssd_scan_ref``: chunk states first, then the sequential
    scan over chunks.  x (Bb,S,Hp,hd), dt (Bb,S,Hp), B/C (Bb,S,ds), A (Hp,)
    negative, or (Bb,Hp) one per row as the kernel takes it.  Returns y
    (Bb,S,Hp,hd)."""
    Bb, S, Hp, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    xc = x.reshape(Bb, nc, Q, Hp, hd)
    dtc = dt.reshape(Bb, nc, Q, Hp)
    Bc = B.reshape(Bb, nc, Q, ds)
    Cc = C.reshape(Bb, nc, Q, ds)

    loga = dtc * (A if A.ndim == 1 else A[:, None, None, :])  # (B,nc,Q,Hp), negative
    l = torch.cumsum(loga, dim=2)  # within-chunk cumulative log decay

    # intra-chunk: y[t] += sum_{s<=t} exp(l_t - l_s) dt_s (C_t . B_s) x_s
    G = torch.einsum("bnqd,bnsd->bnqs", Cc, Bc)  # (B,nc,Q,Q)
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]  # (B,nc,Q,Q,Hp) t,s
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    # a select, not a product: exp(diff) is inf above the diagonal.  The
    # exponent is masked too, so that autograd's product of the select's
    # zero gradient with exp there is 0, not 0 * inf
    W = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    W = W * G[..., None] * dtc[:, :, None, :, :]  # (B,nc,Q,Q,Hp) [t,s]
    y_intra = torch.einsum("bnqsh,bnshp->bnqhp", W, xc)

    # chunk-end states: S_n = sum_s exp(l_Q - l_s) dt_s B_s (x) x_s
    decay_end = torch.exp(l[:, :, -1:, :] - l)  # (B,nc,Q,Hp)
    Sc = torch.einsum("bnsh,bnsd,bnshp->bnhpd", decay_end * dtc, Bc, xc)

    # inter-chunk scan (sequential over nc chunks), emitting the state
    # before each chunk
    A_chunk = torch.exp(l[:, :, -1, :])  # (B,nc,Hp) total chunk decay
    s = torch.zeros((Bb, Hp, hd, ds), dtype=x.dtype, device=x.device)
    S_prev = []
    for n in range(nc):
        S_prev.append(s)
        s = A_chunk[:, n, :, None, None] * s + Sc[:, n]
    S_prev = torch.stack(S_prev, dim=1)  # (B,nc,Hp,hd,ds)

    y_inter = torch.einsum("bnqd,bnhpd->bnqhp", Cc, S_prev) * torch.exp(l)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, Hp, hd)


def ssd_scan_bwd_ref(x, dt, B, C, A, dy, chunk: int):
    """The backward kernel's formulas in plain PyTorch: (dx, ddt, dB, dC, dA)
    of ``ssd_scan_ref`` at the output gradient ``dy``, step by step in the
    order of the kernel's passes (``csrc/ssd_scan.cu``, backward).  A (H,)
    gives dA (H,), summed over rows; A (Bb,H) gives dA (Bb,H).

    Per (row, head, chunk), l the within-chunk cumulative sum of dt A, lQ
    its last value, decay = exp(lQ - l), S_in the state entering the chunk:
    1. l and S_in, as the forward computes them;
    2. each chunk's gradient of its own S_in, sum_t exp(l_t) dy_t^T C_t;
    3. in reverse over the chunks, dS_next[c] (the gradient of the state
       leaving chunk c) = local[c+1] + exp(lQ[c+1]) dS_next[c+1];
    4. per head, from dW = dy x^T and G = C B^T on the causal half (the
       exponent masked before the exp):
       dx = W^T dy + decay dt (B dS_next^T); dG = dW M dt; and the
       pieces of dl: q_t = dy_t . y_inter_t, R = dW * W (row sums add to
       dl, column sums subtract), v = dt u with u = decay (x . B dS_next^T)
       (dl_s -= v_s, dl_Q += sum v), kappa = exp(lQ) <dS_next, S_in>
       (into dl_Q); da_u = sum_{t >= u} dl_t, that is the reverse cumsum
       of q + rowR - colR, plus the exclusive prefix sum of v, plus kappa;
       ddt = sum_t dW M G + u + A da, and dA = sum dt da;
    5. over the heads: dC = sum_h exp(l) (dy S_in) + (sum_h dG) B and
       dB = sum_h decay dt (x dS_next) + (sum_h dG)^T C."""
    Bb, S, H, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    xc, dyc = x.reshape(Bb, nc, Q, H, hd), dy.reshape(Bb, nc, Q, H, hd)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc, Cc = B.reshape(Bb, nc, Q, ds), C.reshape(Bb, nc, Q, ds)
    Ab = A[None, None, None, :] if A.ndim == 1 else A[:, None, None, :]

    # 1. l and the states entering each chunk
    l = torch.cumsum(dtc * Ab, dim=2)  # (Bb,nc,Q,H)
    lQ = l[:, :, -1]  # (Bb,nc,H)
    decay = torch.exp(lQ[:, :, None] - l)
    Sc = torch.einsum("bnsh,bnsd,bnshp->bnhpd", decay * dtc, Bc, xc)
    s = torch.zeros((Bb, H, hd, ds), dtype=x.dtype, device=x.device)
    S_in = []
    for n in range(nc):
        S_in.append(s)
        s = torch.exp(lQ[:, n])[..., None, None] * s + Sc[:, n]
    S_in = torch.stack(S_in, dim=1)  # (Bb,nc,H,hd,ds)

    # 2. each chunk's own gradient of the state entering it
    el = torch.exp(l)
    local = torch.einsum("bnth,bnthp,bntd->bnhpd", el, dyc, Cc)

    # 3. the gradient of the state leaving each chunk, in reverse
    run = torch.zeros_like(s)
    dSn = [None] * nc
    for n in reversed(range(nc)):
        dSn[n] = run
        run = local[:, n] + torch.exp(lQ[:, n])[..., None, None] * run
    dSn = torch.stack(dSn, dim=1)  # (Bb,nc,H,hd,ds)

    # 4. per head
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]  # (Bb,nc,Q,Q,H) [t,s]
    M = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    G = torch.einsum("bntd,bnsd->bnts", Cc, Bc)[..., None]
    dW = torch.einsum("bnthp,bnshp->bntsh", dyc, xc)
    MG = M * G
    W = MG * dtc[:, :, None]
    dG = dW * M * dtc[:, :, None]
    R = dW * W
    BdS = torch.einsum("bnsd,bnhpd->bnshp", Bc, dSn)
    CS = torch.einsum("bntd,bnhpd->bnthp", Cc, S_in)
    dx = torch.einsum("bntsh,bnthp->bnshp", W, dyc) + (decay * dtc)[..., None] * BdS
    u = decay * (xc * BdS).sum(-1)  # (Bb,nc,Q,H)
    q = el * (dyc * CS).sum(-1)
    kappa = torch.exp(lQ) * (dSn * S_in).sum((-1, -2))  # (Bb,nc,H)
    v = dtc * u
    dl = q + R.sum(3) - R.sum(2)
    da = (dl.flip(2).cumsum(2).flip(2) + (v.cumsum(2) - v) + kappa[:, :, None])
    ddt = (dW * MG).sum(2) + u + Ab * da
    dA = (dtc * da).sum((1, 2))  # (Bb,H)
    if A.ndim == 1:
        dA = dA.sum(0)

    # 5. the head sums
    dGs = dG.sum(-1)
    dC = (torch.einsum("bnth,bnthp,bnhpd->bntd", el, dyc, S_in)
          + torch.einsum("bnts,bnsd->bntd", dGs, Bc))
    dB = (torch.einsum("bnsh,bnshp,bnhpd->bnsd", decay * dtc, xc, dSn)
          + torch.einsum("bnts,bntd->bnsd", dGs, Cc))
    return (dx.reshape(x.shape), ddt.reshape(dt.shape), dB.reshape(B.shape),
            dC.reshape(C.shape), dA)


def ssd_recurrence(x, dt, B, C, A):
    """The exact sequential recurrence the chunked SSD equals, one step per
    token in float64: s_t = exp(dt_t A) s_{t-1} + dt_t x_t (x) B_t and
    y_t = s_t C_t (the oracle of the reference's
    ``test_ssd_kernel_matches_sequential_recurrence``).  Returns float64."""
    x, dt, B, C, A = (t.double() for t in (x, dt, B, C, A))
    Bb, S, H, hd = x.shape
    s = torch.zeros((Bb, H, hd, B.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)  # (Bb,H)
        s = a[..., None, None] * s + torch.einsum(
            "bh,bhp,bd->bhpd", dt[:, t], x[:, t], B[:, t])
        ys.append(torch.einsum("bhpd,bd->bhp", s, C[:, t]))
    return torch.stack(ys, dim=1)
