"""The port's attention against the JAX package's.

On the CPU the port's attention runs its plain PyTorch version; it is held
against the Pallas kernel (interpret mode, as tests/test_kernels.py runs it),
against ``attention_ref`` and against the model path's ``chunked_attention``.
tests/test_torch_cuda.py holds the CUDA kernel against the plain version on
the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import attention as pallas_attention
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models.attention import chunked_attention as jax_chunked_attention
from repro_torch.core.compat import assert_close
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.kernels.ref import (
    attention_lse_ref, attention_ref, chunked_attention_ref, flash_attention_bwd_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


def _qkv(rng, q_shape, kv_shape, dtype):
    return [_pair(rng.standard_normal(s), dtype) for s in (q_shape, kv_shape, kv_shape)]


# Pallas scales q and keeps p in float32 where the model path (and so the
# port) rounds both to the input dtype: in bf16 that is one rounding apart.
PALLAS_TOL = {"float32": "f32_chain", "bfloat16": "bf16_round"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,bk", [(1, 2, 2, 128, 64, 64), (2, 2, 1, 256, 32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_kernel(B, Hq, Hkv, S, D, bk, causal, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (B, Hq, S, D), (B, Hkv, S, D), dtype)
    want = pallas_attention(qj, kj, vj, causal=causal, block_q=64, block_k=bk)
    got = ops.attention(qt, kt, vt, causal=causal, block_k=bk)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Hq, S, D)
    assert_close(got, want, PALLAS_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,causal", [(64, 64, True), (32, 96, True), (48, 80, False)])
def test_attention_ref_matches_reference(S, T, causal, dtype):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (2, 4, S, 32), (2, 2, T, 32), dtype)
    want = jax_attention_ref(qj, kj, vj, causal=causal, group_size=2)
    got = attention_ref(qt, kt, vt, causal=causal, group_size=2)
    # float32 throughout, rounded once: only the contraction order differs
    assert_close(got, want, "f32_dot" if dtype == "float32" else "bf16_round")


# (B, S, T, KR, Gl, D, causal, chunk, q_offset, kv_len): GQA with Gl > 1,
# continuation with q_offset, a kv_len prefix, S != T and a ragged last chunk
MODEL_CASES = [
    (2, 40, 40, 2, 3, 32, True, 16, 0, None),
    (1, 24, 72, 1, 4, 64, True, 32, 48, None),
    (2, 1, 64, 2, 2, 32, False, 64, 37, 38),
    (2, 1, 50, 3, 1, 64, False, 50, 0, 1),
    (1, 16, 100, 2, 2, 128, True, 32, 84, 100),
    (2, 8, 60, 1, 2, 32, False, 25, 10, 45),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,KR,Gl,D,causal,chunk,q_offset,kv_len", MODEL_CASES)
def test_model_layout_matches_chunked_attention(B, S, T, KR, Gl, D, causal, chunk,
                                                q_offset, kv_len, dtype):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (B, S, KR, Gl, D), (B, T, KR, D), dtype)
    want = jax_chunked_attention(qj, kj, vj, causal=causal, chunk=chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    got = ops.attention_model_layout(qt, kt, vt, causal=causal, chunk=chunk,
                                     q_offset=q_offset, kv_len=kv_len)
    # the same steps: float32 scores may round p to the other bf16 neighbour
    assert_close(got, want, "f32_dot" if dtype == "float32" else "bf16_round")


def test_reference_layout_is_a_view_of_the_model_layout():
    rng = np.random.default_rng(3)
    B, Hkv, G, S, D = 2, 2, 3, 40, 32
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, S, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
            for _ in range(2))
    got = ops.attention(q, k, v, causal=True, block_k=16)
    qm = q.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4).contiguous()
    want = chunked_attention_ref(qm, k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal=True, chunk=16)
    assert_close(got, want.permute(0, 2, 3, 1, 4).reshape(B, Hkv * G, S, D), "exact")


def test_kernel_takes_only_cuda_tensors():
    q = torch.zeros(1, 4, 1, 1, 32)
    k = torch.zeros(1, 4, 1, 32)
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="cuda"):
        ops.attention_model_layout(q.to("meta"), k.to("meta"), k.to("meta"))
    assert fa.launches == before


BF16, F32 = torch.bfloat16, torch.float32


# (q dtype, kv dtype, S, Gl, variant): R = S * Gl <= 16 decodes on the CUDA
# cores for every dtype pair; above that bf16 takes the tensor cores and
# float32 q the CUDA-core prefill
@pytest.mark.parametrize("q_dtype,kv_dtype,S,Gl,variant", [
    (BF16, BF16, 1, 1, "decode_splitkv"),
    (BF16, BF16, 4, 4, "decode_splitkv"),
    (F32, F32, 1, 3, "decode_splitkv"),
    (F32, BF16, 16, 1, "decode_splitkv"),
    (BF16, BF16, 17, 1, "prefill_wgmma"),
    (BF16, BF16, 6, 3, "prefill_wgmma"),
    (BF16, BF16, 2048, 1, "prefill_wgmma"),
    (F32, F32, 300, 1, "prefill_f32"),
    (F32, BF16, 9, 2, "prefill_f32"),
])
def test_plan_picks_the_variant_by_dtype_and_rows(q_dtype, kv_dtype, S, Gl, variant):
    pl = fa.plan(2, S, 4, Gl, 4096, 64, q_dtype, kv_dtype, causal=True, q_offset=4096 - S)
    assert pl.variant == variant
    assert pl.splits == 1 or variant == "decode_splitkv"


@pytest.mark.parametrize("B,KR,kv_len", [
    (8, 16, 1024), (8, 16, 1), (8, 16, 63), (8, 16, 130), (1, 1, 100_000),
    (1, 2, 1000), (2, 2, 651), (8, 8, 1024), (64, 16, 4096), (1, 16, 193),
])
def test_plan_splits_decode_kv(B, KR, kv_len):
    pl = fa.plan(B, 1, KR, 1, max(kv_len, 1024), 128, BF16, BF16, causal=False,
                 q_offset=kv_len - 1, kv_len=kv_len)
    assert pl.variant == "decode_splitkv" and 1 <= pl.splits <= fa.MAX_SPLITS
    # the kernel cuts kv_len keys into even shares: the smallest is floor(kv_len / splits)
    assert kv_len // pl.splits >= fa.MIN_SPLIT_KEYS or pl.splits == 1
    # two blocks per SM at least, unless kv_len or the cap allows no more splits
    most = min(fa.MAX_SPLITS, max(1, kv_len // fa.MIN_SPLIT_KEYS))
    assert pl.splits * B * KR >= 2 * fa.SMS or pl.splits == most


def test_plan_counts_only_the_keys_a_causal_call_can_see():
    """Causal rows at q_offset 99 see 100 keys of a 4096-key cache: one split."""
    pl = fa.plan(1, 2, 2, 1, 4096, 64, BF16, BF16, causal=True, q_offset=99)
    assert pl.splits == 1
    assert fa.plan(1, 2, 2, 1, 4096, 64, BF16, BF16, causal=False, q_offset=99).splits == 32


H100_SMS = 132  # streaming multiprocessors of an H100 SXM, as the wrapper reads them

# (Bb, S, H, hd, ds, chunk): the Mamba2 loss shape and B = 1 of it, Q = 48,
# Q = 40, 36 and 100 (ragged tiles), H = 5 (a short last head group),
# S < chunk, and the small state dims
SSD_PLAN_SHAPES = [
    (8, 2048, 24, 64, 128, 128),
    (1, 2048, 24, 64, 128, 128),
    (2, 144, 24, 64, 128, 48),
    (2, 144, 3, 64, 128, 36),
    (1, 100, 2, 64, 128, 128),
    (1, 2048, 5, 64, 128, 128),
    (1, 120, 2, 64, 128, 40),
    (2, 64, 3, 64, 128, 128),
    (1, 256, 1, 32, 16, 128),
    (2, 256, 3, 32, 128, 64),
]


def test_ssd_plan_fills_two_waves_at_the_loss_shape():
    pl = ssd_kernel.plan(8, 2048, 24, 64, 128, 128, sms=H100_SMS)
    assert math.prod(pl.out_grid) >= 2 * H100_SMS
    assert pl.state_grid == (16, 24, 8) and math.prod(pl.state_grid) >= 2 * H100_SMS


@pytest.mark.parametrize("Bb,H,head_group,groups", [
    (8, 24, 8, 3),  # 384 blocks: three waves of 8 heads
    (1, 24, 3, 8),  # 128 blocks: one wave
    (1, 5, 1, 5),   # 80 blocks even with one head each
    (2, 5, 2, 3),   # 96 blocks: the last group is one head short
])
def test_ssd_plan_picks_the_head_group_by_waves(Bb, H, head_group, groups):
    pl = ssd_kernel.plan(Bb, 2048, H, 64, 128, 128, sms=H100_SMS)
    assert (pl.head_group, pl.out_grid[1]) == (head_group, groups)


@pytest.mark.parametrize("Bb,S,H,hd,ds,chunk", SSD_PLAN_SHAPES)
def test_ssd_plan_computes_g_once_per_head_group(Bb, S, H, hd, ds, chunk):
    """G = C B^T is computed once per (batch row, chunk) in each block of
    ssd_chunk_out, for all heads of its group: the groups cover the H heads
    exactly once, so no head's G is computed twice."""
    pl = ssd_kernel.plan(Bb, S, H, hd, ds, chunk, sms=H100_SMS)
    nc, groups, b = pl.out_grid
    assert (nc, b) == (S // min(chunk, S), Bb) and pl.chunks == nc
    assert 1 <= pl.head_group <= ssd_kernel.HEAD_GROUP
    assert pl.head_group * (groups - 1) < H <= pl.head_group * groups


@pytest.mark.parametrize("Bb,S,H,hd,ds,chunk", SSD_PLAN_SHAPES)
def test_ssd_plan_sizes_the_scratch(Bb, S, H, hd, ds, chunk):
    pl = ssd_kernel.plan(Bb, S, H, hd, ds, chunk, sms=H100_SMS)
    Q, nc = pl.chunk, pl.chunks
    assert Q == min(chunk, S) and nc * Q == S
    assert pl.lsum_shape == (Bb, nc, H, Q) and pl.state_shape == (Bb, nc, H, hd, ds)
    assert pl.scratch_bytes == 4 * Bb * nc * H * (hd * ds + Q)
    assert pl.scratch_bytes == 4 * (math.prod(pl.lsum_shape) + math.prod(pl.state_shape))
    # the state pass: four state values per thread cover hd * ds once
    slices, h, b = pl.scan_grid
    assert (h, b) == (H, Bb)
    assert (slices - 1) * 4 * ssd_kernel.STATE_THREADS < hd * ds <= slices * 4 * ssd_kernel.STATE_THREADS


def test_ssd_plan_scratch_at_the_loss_shape():
    """100.7 MB of chunk states and 1.6 MB of l at B8 S2048 H24 hd64 ds128."""
    pl = ssd_kernel.plan(8, 2048, 24, 64, 128, 128, sms=H100_SMS)
    assert 4 * math.prod(pl.state_shape) == 100_663_296
    assert pl.scratch_bytes == 100_663_296 + 1_572_864


def test_ssd_plan_refuses_a_sequence_that_is_no_multiple_of_the_chunk():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_kernel.plan(1, 200, 2, 64, 128, 128, sms=H100_SMS)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_kernel.plan(1, 256, 2, 64, 128, 129, sms=H100_SMS)


# ---------------------------------------------------------------------------------
# the gradient: the port's autograd through the plain version against
# jax.grad of the JAX package's chunked_attention, and the backward kernel's
# formulas (flash_attention_bwd_ref) against that autograd
# ---------------------------------------------------------------------------------

# float32: contractions in another order; bf16: the reference's cotangents
# are rounded at other points than PyTorch's (per chunk, in XLA's fusions)
GRAD_TOL = {"float32": "f32_chain", "bfloat16": "bf16_chain"}


def _attention_vjp_inputs(rng, S, Gl, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (2, S, 2, Gl, D), (2, S, 2, D), dtype)
    doj, dot = _pair(rng.standard_normal((2, S, 2, Gl, D)), dtype)
    return (qj, kj, vj, doj), (qt, kt, vt, dot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Gl", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_matches_jax_grad(causal, Gl, D, dtype):
    """dq, dk, dv of chunked_attention: S = 40 over chunks of 16 (a ragged
    last chunk), GQA with Gl = 3."""
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _attention_vjp_inputs(
        np.random.default_rng(10), 40, Gl, D, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_chunked_attention(q, k, v, causal=causal, chunk=16),
                     qj, kj, vj)
    want = vjp(doj)
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = ops.attention_model_layout(q, k, v, causal=causal, chunk=16)
    got = torch.autograd.grad(out, (q, k, v), dot)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == DTYPES[dtype][1]
        assert_close(g, w, GRAD_TOL[dtype], err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Gl,S", [(True, 1, 40), (True, 3, 33), (False, 2, 40)])
def test_flash_attention_bwd_ref_matches_autograd(causal, Gl, S, dtype):
    """The kernel's formulas (P from the forward's log-sum-exp, Delta from
    its output) against autograd through the plain forward."""
    _, (qt, kt, vt, dot) = _attention_vjp_inputs(np.random.default_rng(11), S, Gl, 32, dtype)
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = chunked_attention_ref(q, k, v, causal=causal, chunk=16)
    want = torch.autograd.grad(out, (q, k, v), dot)
    lse = attention_lse_ref(qt, kt, causal=causal)
    got = flash_attention_bwd_ref(qt, kt, vt, out.detach(), lse, dot, causal=causal)
    # float32: the same sums in another order; bf16: the formulas round dS
    # and P (and take Delta from the rounded output) where autograd rounds
    # the chunks' cotangents
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype
        assert_close(g, w, "f32_chain" if dtype == "float32" else "bf16_round",
                     err_msg=f"d{name}")


def test_gradient_through_the_kernel_path_raises_where_it_is_not_covered():
    """On the card a gradient-requiring call that the backward kernel does
    not cover raises (checked before any launch, so it shows here); it never
    falls back to the plain version."""
    q = torch.zeros(1, 32, 1, 1, 64, requires_grad=True)
    k = torch.zeros(1, 32, 1, 64)
    for kw, why in (({"q_offset": 4}, "q_offset"), ({"kv_len": 16}, "kv_len")):
        with pytest.raises(RuntimeError, match=why):
            fab.check_trainable(q, k, k, **kw)
    with pytest.raises(RuntimeError, match="dtypes"):
        fab.check_trainable(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(RuntimeError, match="decode"):
        fab.check_trainable(q[:, :8], k, k)
    fab.check_trainable(q, k, k)  # the training call itself is covered


# ---------------------------------------------------------------------------------
# the backward kernel's plan: bf16 runs bwd_prep, bwd_main and bwd_dq_out on
# scratch of R rows padded to the 64-row tile; float32 two CUDA-core launches
# ---------------------------------------------------------------------------------


# (B, S, KR, Gl, T, D): the training call, ragged R (Gl = 3, S not a
# multiple of 64) and ragged T (not a multiple of the 128-key block)
@pytest.mark.parametrize("B,S,KR,Gl,T,D", [
    (4, 2048, 16, 1, 2048, 64), (2, 70, 2, 3, 70, 64), (1, 300, 2, 3, 300, 128),
    (2, 190, 3, 1, 190, 32), (1, 17, 1, 1, 200, 64), (10, 256, 16, 1, 256, 64),
])
def test_bwd_plan_pads_rows_to_the_tile_and_covers_every_launch(B, S, KR, Gl, T, D):
    pl = fab.plan(B, S, KR, Gl, T, D, BF16)
    R = S * Gl
    assert pl.variant == "wgmma" and (fab.BLOCK_Q, fab.BLOCK_K) == (64, 128)
    assert pl.rows_padded % 64 == 0 and R <= pl.rows_padded < R + 64
    prep, main, out = pl.grids
    assert prep * fab.PREP_THREADS == B * KR * pl.rows_padded * (D // 8)  # every padded row
    assert main == -(-T // 128) * KR * B  # every key, one block per 128
    assert (out - 1) * fab.OUT_THREADS < B * KR * R * (D // 8) <= out * fab.OUT_THREADS
    rows = (B * KR, pl.rows_padded)
    assert pl.scratch == {"qf": ((*rows, D), BF16), "dob": ((*rows, D), BF16),
                          "lse_p": (rows, F32), "delta": (rows, F32),
                          "dq_acc": ((*rows, D), F32)}


def test_bwd_plan_at_the_training_call():
    """B4 S2048 H16 D64: 1024 main blocks, a 33.5 MB dq accumulator."""
    pl = fab.plan(4, 2048, 16, 1, 2048, 64, BF16)
    assert pl.rows_padded == 2048 and pl.grids == (4096, 1024, 4096)
    nbytes = {n: math.prod(shape) * torch.finfo(dt).bits // 8 for n, (shape, dt) in pl.scratch.items()}
    assert nbytes["dq_acc"] == 4 * 16 * 2048 * 64 * 4 == 33554432
    assert nbytes["qf"] == nbytes["dob"] == 16777216


def test_bwd_plan_for_float32_keeps_the_cuda_core_pair():
    pl = fab.plan(1, 130, 2, 3, 130, 32, F32)
    assert pl.variant == "f32" and pl.grids == ()
    assert pl.scratch == {"delta": ((1, 2, 390), F32)}
