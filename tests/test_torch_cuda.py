"""The port on the card: the CUDA flash-attention and SSD-scan kernels
(forward and backward) against their plain PyTorch versions, and the serving,
forward and training paths on CUDA against the same paths on the CPU.  Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import TOLERANCES, assert_close
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.kernels import ssd_scan_bwd as ssd_bwd_kernel
from repro_torch.kernels.ref import (
    NEG_INF, attention_lse_ref, attention_ref, chunked_attention_ref, flash_attention_bwd_ref,
    flash_decode_partial_ref, ssd_recurrence, ssd_scan_bwd_ref, ssd_scan_ref,
)
from repro_torch.models import api
from repro_torch.models.layers import tree_init
from repro_torch.train.loop import TrainConfig, init_state, make_train_step, value_and_grad
from repro_torch.train.optimizer import get_optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    return torch.device("cuda")


# (B, S, T, KR, Gl, D, causal, chunk, q_offset, kv_len): GQA with Gl > 1,
# continuation with q_offset, a kv_len prefix, S != T, ragged q and kv tiles.
# In bf16, R = S * Gl > 16 takes the tensor-core prefill, R <= 16 the split-kv
# decode (float32 prefill takes the CUDA-core kernel)
CASES = [
    (2, 40, 40, 2, 3, 32, True, 16, 0, None),
    (1, 24, 72, 1, 4, 64, True, 32, 48, None),
    (2, 1, 64, 2, 2, 32, False, 64, 37, 38),
    (2, 1, 50, 3, 1, 64, False, 50, 0, 1),
    (1, 16, 100, 2, 2, 128, True, 32, 84, 100),
    (2, 8, 60, 1, 2, 32, False, 25, 10, 45),
    (1, 300, 300, 2, 1, 128, True, 128, 0, None),
    # prefill: S not a multiple of 128, T not a multiple of the 128-key tile
    (1, 200, 300, 2, 1, 64, True, 128, 100, None),
    # Gl = 3 at D = 128 (q rows straddle (s, g) across the 128-row tile)
    (1, 100, 100, 2, 3, 128, True, 64, 0, None),
    # D = 32 (64-byte swizzle), causal, two q tiles
    (2, 130, 130, 2, 1, 32, True, 64, 0, None),
    # q_offset with S != T, GQA
    (1, 64, 200, 2, 2, 64, True, 64, 136, None),
    # kv_len < T in prefill, non-causal and causal
    (2, 150, 256, 1, 1, 64, False, 128, 0, 190),
    (1, 96, 160, 2, 2, 64, True, 64, 40, 120),
    # decode: a ragged last split (1000 keys over 15 splits), Gl > 1 at
    # D = 128, and causal rows (S = 4, Gl = 3) that see different prefixes
    (1, 1, 1024, 2, 1, 64, False, 1024, 999, 1000),
    (2, 1, 700, 2, 4, 128, False, 700, 650, 651),
    (1, 4, 600, 2, 3, 64, True, 600, 500, 504),
]
# p is rounded to the kv dtype at the kernel's kv tiles rather than the plain
# version's chunks (and, in decode, against each split's own max): one bf16
# rounding apart; float32 differs in summation order only
TOL = {torch.float32: "f32_chain", torch.bfloat16: "bf16_round"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,KR,Gl,D,causal,chunk,q_offset,kv_len", CASES)
def test_kernel_matches_plain(cuda, B, S, T, KR, Gl, D, causal, chunk, q_offset, kv_len, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, S, KR, Gl, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, T, KR, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    before = fa.launches
    got = ops.attention_model_layout(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = chunked_attention_ref(q, k, v, causal=causal, chunk=chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("T,pos", [(96, 70), (1024, 900)])
def test_kernel_f32_queries_on_bf16_cache(cuda, T, pos):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(3, 1, 4, 2, 64, generator=g, device=cuda)
    k, v = (torch.randn(3, T, 4, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    got = ops.attention_model_layout(q, k, v, causal=False, chunk=T, q_offset=pos, kv_len=pos + 1)
    assert got.dtype == torch.float32
    want = chunked_attention_ref(q, k, v, causal=False, chunk=T, q_offset=pos, kv_len=pos + 1)
    assert_close(got, want, "bf16_round")


def test_decode_reads_a_layer_slice_of_the_cache(cuda):
    """k/v as layer l of an (L,B,T,KR,D) cache, as the decode step passes them."""
    g = torch.Generator(device=cuda).manual_seed(3)
    ck, cv = (torch.randn(3, 2, 512, 4, 64, generator=g, device=cuda).bfloat16()
              for _ in range(2))
    q = torch.randn(2, 1, 4, 1, 64, generator=g, device=cuda).bfloat16()
    for layer in range(3):
        got = ops.attention_model_layout(q, ck[layer], cv[layer], causal=False, chunk=512,
                                         q_offset=400, kv_len=401)
        want = chunked_attention_ref(q, ck[layer], cv[layer], causal=False, chunk=512,
                                     q_offset=400, kv_len=401)
        assert_close(got, want, "bf16_round")


def test_kernel_reference_layout(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 6, 256, 64, generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn(1, 2, 256, 64, generator=g, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    got = ops.attention(q, k, v, causal=True)
    # attention_ref keeps q and p in float32 where the kernel rounds them to bf16
    assert_close(got, attention_ref(q, k, v, causal=True, group_size=3), "bf16_round")


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 4, 1, 1, 48, device=cuda)
    k = torch.zeros(1, 4, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, k, causal=True)
    q = torch.zeros(1, 4, 1, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q[:, :, :, 0].float(), q[:, :, :, 0].float(), causal=True)
    # rows 136 bytes apart: neither TMA nor 16-byte loads take them
    k = torch.zeros(1, 4, 1, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(q, k, k, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_on_cuda_matches_cpu(cuda, dtype):
    """Five decode steps of the reduced model on the card (the kernel) and on
    the CPU (the plain version), from the same weights."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 32).with_(dtype=dtype)
    st = get_strategy("2d_finalized")
    cpu = tree_init(api.param_tree(cfg, st), torch.Generator().manual_seed(0),
                    dtype=dtype, device="cpu")
    gpu = {k: v for k, v in _to(cpu, cuda).items()}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))
    shapes = api.cache_shapes(cfg, st, 2, 16)
    caches = [{k: torch.zeros(v, dtype=torch.bfloat16, device=d) for k, v in shapes.items()}
              for d in ("cpu", cuda)]
    fa.launches = 0
    for pos in range(5):
        tok = torch.from_numpy(tokens[:, pos:pos + 1])
        want, caches[0] = api.decode_step(cfg, st, cpu, tok, caches[0], pos)
        got, caches[1] = api.decode_step(cfg, st, gpu, tok.to(cuda), caches[1], pos)
        # float32: matmuls and the kernel sum in another order than the CPU;
        # bfloat16: cuBLAS and the CPU round some activations the other way
        assert_close(got, want, "f32_chain" if dtype == "float32" else "bf16_chain")
    assert fa.launches == 5 * cfg.num_layers


# (B, S, H, hd, ds, chunk): chip_smoke.py's cases (the Mamba2 loss shape,
# B = 1 of it, S < chunk so Q = S, hd 32 / ds 16), a chunk of 64, and a
# chunk that is no power of two; then Q = 16 (one m tile), Q = 40 (tile rows
# padded to 48), H = 5 (groups of 2 heads, the last one short), hd 32 with
# ds 128, hd 64 with ds 16, 16 chunks through the state pass at B = 1, and
# two chunks that are no multiple of 8: Q = 100 (S < chunk; rows padded to
# 104 in the state pass and 112 in the output pass) and Q = 36 (40 and 48)
SSD_CASES = [
    (8, 2048, 24, 64, 128, 128),
    (1, 2048, 24, 64, 128, 128),
    (2, 64, 3, 64, 128, 128),
    (1, 256, 1, 32, 16, 128),
    (2, 256, 3, 64, 128, 64),
    (1, 144, 2, 64, 128, 48),
    (2, 128, 3, 64, 128, 16),
    (1, 120, 2, 64, 128, 40),
    (2, 2048, 5, 64, 128, 128),
    (2, 256, 3, 32, 128, 64),
    (1, 256, 2, 64, 16, 128),
    (1, 2048, 3, 64, 128, 128),
    (1, 100, 2, 64, 128, 128),
    (2, 144, 3, 64, 128, 36),
]


def _ssd_inputs(device, B, S, H, hd, ds, seed=0):
    """tests/test_kernels.py's distributions."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, S, H, hd, generator=g, device=device),
            torch.randn(B, S, H, generator=g, device=device).abs() * 0.5,
            torch.randn(B, S, ds, generator=g, device=device) * 0.2,
            torch.randn(B, S, ds, generator=g, device=device) * 0.2,
            -torch.randn(H, generator=g, device=device).abs())


@pytest.mark.parametrize("B,S,H,hd,ds,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, S, H, hd, ds, chunk):
    args = _ssd_inputs(cuda, B, S, H, hd, ds)
    before = ssd_kernel.launches
    got = ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    # the kernel carries the state chunk to chunk, the plain version scans
    # chunk states: the same float32 sums, reassociated
    assert_close(got, ssd_scan_ref(*args, chunk), "f32_chain")


def test_ssd_kernel_matches_sequential_recurrence(cuda):
    args = _ssd_inputs(cuda, 1, 64, 2, 32, 16, seed=1)
    got = ssd_kernel.ssd_scan(*args, chunk=32)
    assert_close(got, ssd_recurrence(*args), "f32_chain")


def test_ssd_kernel_takes_strided_views(cuda):
    """x, dt and A as head slices of wider tensors, B and C as column slices."""
    x, dt, B, C, A = _ssd_inputs(cuda, 2, 256, 6, 64, 128, seed=2)
    BC = torch.cat([B, C], dim=-1)
    got = ssd_kernel.ssd_scan(x[:, :, 1:4], dt[:, :, 1:4], BC[..., :128], BC[..., 128:], A[1:4])
    assert_close(got, ssd_scan_ref(x[:, :, 1:4], dt[:, :, 1:4], B, C, A[1:4], 128), "f32_chain")


def test_ssd_kernel_keeps_float32_accuracy_at_large_x(cuda):
    """x scaled by 10^3: y is of order 10^3, so f32_chain's atol no longer
    hides a relative error, and a kernel whose TF32 split dropped a lo term
    (about 5e-4 relative) fails.  x, B and C are taken non-negative, so no
    output is a near-cancelling sum: with signed inputs the plain float32
    version itself lands outside rtol at a few hundred near-zero outputs of
    this shape against float64, since any float32 sum errs by eps times the
    sum of its terms' magnitudes, not of its result."""
    x, dt, B, C, A = _ssd_inputs(cuda, 2, 512, 3, 64, 128, seed=3)
    x, B, C = x.abs() * 1e3, B.abs(), C.abs()
    got = ssd_kernel.ssd_scan(x, dt, B, C, A)
    want = ssd_scan_ref(*(t.double() for t in (x, dt, B, C, A)), 128)
    assert_close(got, want, "f32_chain")


def test_ssd_kernel_keeps_float32_accuracy_on_cancelling_sums(cuda):
    """Signed x scaled by 10^3, as the model's sums cancel: against float64,
    the kernel's largest error stays within 4x of the plain float32
    version's on the same inputs.  3xTF32 rounds each operand to about
    2^-22 relative where float32 keeps 2^-24, so a kernel that keeps
    float32's accuracy errs about as much as float32 does; one that drops
    its hi * lo term fails (tools/ssd_ablation.py checks that it does)."""
    x, dt, B, C, A = _ssd_inputs(cuda, 2, 512, 3, 64, 128, seed=3)
    x = x * 1e3
    want = ssd_scan_ref(*(t.double() for t in (x, dt, B, C, A)), 128)
    kernel_err = (ssd_kernel.ssd_scan(x, dt, B, C, A).double() - want).abs().max().item()
    plain_err = (ssd_scan_ref(x, dt, B, C, A, 128).double() - want).abs().max().item()
    assert 0 < plain_err and kernel_err <= 4 * plain_err, (kernel_err, plain_err)


def test_ssd_kernel_takes_rows_that_are_not_16_byte_aligned(cuda):
    """Row strides that are no multiple of four floats: the kernel moves rows
    in 4-byte pieces."""
    x, dt, B, C, A = _ssd_inputs(cuda, 2, 256, 3, 64, 128, seed=4)
    xw = torch.zeros(2, 256, 3, 65, device=cuda)
    xw[..., 1:] = x
    BC = torch.zeros(2, 256, 257, device=cuda)
    BC[..., 1:129], BC[..., 129:] = B, C
    got = ssd_kernel.ssd_scan(xw[..., 1:], dt, BC[..., 1:129], BC[..., 129:], A, chunk=64)
    assert_close(got, ssd_scan_ref(x, dt, B, C, A, 64), "f32_chain")


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    args = _ssd_inputs(cuda, 1, 256, 2, 64, 128)
    with pytest.raises(TypeError, match="float32"):
        ssd_kernel.ssd_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_kernel.ssd_scan(*(a[:, :200] if a.ndim > 1 else a for a in args))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(*(a.cpu() for a in args))
    with pytest.raises(ValueError, match="hd, ds"):
        ssd_kernel.ssd_scan(args[0][..., :48].contiguous(), *args[1:])
    x = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        ssd_kernel.ssd_scan(x, *args[1:])
    with torch.no_grad():
        ssd_kernel.ssd_scan(x, *args[1:])


def _assert_bf16_logits_agree(got, want):
    """bfloat16 Mamba2 with random weights is chaotic under rounding
    (ROADMAP R6): on the H100, 9 of 3.2 million forward logits landed just
    outside the elementwise bf16_chain class (0.098 against 0.08).  So the
    comparison is in norm, at bf16_chain's rtol, and by argmax wherever the
    top-2 margin is wider than bf16_chain's bound."""
    rtol, atol = TOLERANCES["bf16_chain"]
    got, want = got.float().cpu(), want.float()
    assert ((got - want).norm() / want.norm()).item() <= rtol
    top2 = want.topk(2, dim=-1).values
    wide = top2[..., 0] - top2[..., 1] > 2 * (atol + rtol * top2[..., 0].abs())
    assert bool(((got.argmax(-1) == want.argmax(-1)) | ~wide).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_on_cuda_matches_cpu(cuda, dtype):
    """The reduced Mamba2 on the card (the SSD kernel in the forward, the
    recurrent decode) and on the CPU (the plain version), same weights."""
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(dtype=dtype)
    st = get_strategy("2d_finalized")
    cpu = tree_init(api.param_tree(cfg, st), torch.Generator().manual_seed(0),
                    dtype=dtype, device="cpu")
    gpu = _to(cpu, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256)))

    def agree(got, want):
        if dtype == "float32":  # sums in another order: tests/test_torch_ssm.py's class
            assert_close(got, want, "coarse")
        else:
            _assert_bf16_logits_agree(got, want)

    ssd_kernel.launches = 0
    with torch.inference_mode():
        got = api.forward(cfg, st, gpu, tokens.to(cuda))
    assert ssd_kernel.launches == cfg.num_layers
    agree(got, api.forward(cfg, st, cpu, tokens))
    shapes = api.cache_shapes(cfg, st, 2, 16)
    caches = [{k: torch.zeros(v, dtype=torch.float32 if k == "s" else torch.bfloat16, device=d)
               for k, v in shapes.items()} for d in ("cpu", cuda)]
    for pos in range(5):
        tok = tokens[:, pos:pos + 1]
        want, caches[0] = api.decode_step(cfg, st, cpu, tok, caches[0], pos)
        got, caches[1] = api.decode_step(cfg, st, gpu, tok.to(cuda), caches[1], pos)
        agree(got, want)
    assert ssd_kernel.launches == cfg.num_layers  # decode is recurrent


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------------
# the backward kernel and training on the card
# ---------------------------------------------------------------------------------

# (B, S, KR, Gl, D, causal, dtype): the qwen training call (B4 S2048 H16 D64),
# GQA Gl = 3 at D = 128, D = 32, a ragged S = 1000, non-causal, and float32
# (the CUDA-core kernels) at each D; then, for bf16's 64-row tiles and
# 128-key blocks: Gl = 3 with R = 210 (no multiple of 64) at D = 64, S = 190
# (no multiple of 128) at D = 32, and B * KR = 160 blocks per kv tile (more
# than the H100's 132 SMs)
BWD_CASES = [
    (4, 2048, 16, 1, 64, True, torch.bfloat16),
    (1, 300, 2, 3, 128, True, torch.bfloat16),
    (2, 256, 4, 1, 32, True, torch.bfloat16),
    (2, 1000, 4, 1, 64, True, torch.bfloat16),
    (2, 200, 2, 2, 64, False, torch.bfloat16),
    (1, 130, 2, 3, 32, True, torch.float32),
    (2, 200, 2, 1, 64, False, torch.float32),
    (1, 100, 2, 2, 128, True, torch.float32),
    (2, 70, 2, 3, 64, True, torch.bfloat16),
    (2, 190, 3, 1, 32, True, torch.bfloat16),
    (10, 256, 16, 1, 64, True, torch.bfloat16),
]
# bf16: P and dS are rounded to bf16 at the same points as the plain
# version, but the kernel's exp and sums land some of them on the other
# side of a rounding, and dq's float32 sums are added by atomics in an order
# that changes from run to run: one bf16 rounding of sums taken in varying
# order apart; float32: sum order only
BWD_TOL = {torch.float32: "f32_chain", torch.bfloat16: "bf16_round"}


def _bwd_inputs(cuda, B, S, KR, Gl, D, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, KR, Gl, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, KR, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(B, S, KR, Gl, D, generator=g, device=cuda).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("B,S,KR,Gl,D,causal,dtype", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, B, S, KR, Gl, D, causal, dtype):
    q, k, v, do = _bwd_inputs(cuda, B, S, KR, Gl, D, dtype)
    lse = torch.empty(B, KR, S * Gl, device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, lse=lse)
    # the forward's log-sum-exp: float32 sums in another order
    assert_close(lse, attention_lse_ref(q, k, causal=causal), "f32_chain")
    before = fab.launches
    got = fab.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fab.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    for name, gt, w in zip("qkv", got, want):
        assert gt.dtype == dtype and bool(torch.isfinite(gt).all())
        assert_close(gt, w, BWD_TOL[dtype], err_msg=f"d{name}")


def test_backward_kernel_repeats_dk_dv_bit_for_bit(cuda):
    """Two calls on one input: dq's atomic float32 sums may land in another
    order (one bf16 rounding apart, as against the plain version), dk and dv
    are summed in a fixed order and repeat exactly."""
    q, k, v, do = _bwd_inputs(cuda, 2, 1000, 4, 1, 64, torch.bfloat16, seed=2)
    lse = torch.empty(2, 4, 1000, device=cuda)
    out = fa.flash_attention(q, k, v, causal=True, lse=lse)
    first, second = (fab.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert_close(second[0], first[0], "bf16_round", err_msg="dq")
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


def test_gradient_through_the_kernel_matches_autograd_of_the_plain_version(cuda):
    """loss.backward() through ops.attention_model_layout (the forward and
    backward kernels) against autograd through the plain version, GQA."""
    q, k, v, do = _bwd_inputs(cuda, 2, 160, 2, 3, 64, torch.bfloat16, seed=1)
    grads = []
    for attend in (ops.attention_model_layout, chunked_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (attend(*leaves, causal=True, chunk=64).float() * do.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, gt, w in zip("qkv", *grads):
        assert_close(gt, w, "bf16_round", err_msg=f"d{name}")


def test_gradient_requiring_calls_the_backward_does_not_cover_raise(cuda):
    q, k, v, _ = _bwd_inputs(cuda, 1, 64, 2, 1, 64, torch.bfloat16)
    q.requires_grad_()
    before = (fa.launches, fab.launches)
    with pytest.raises(RuntimeError, match="q_offset"):
        ops.attention_model_layout(q, k, v, causal=True, q_offset=8)
    with pytest.raises(RuntimeError, match="kv_len"):
        ops.attention_model_layout(q, k, v, causal=True, kv_len=32)
    assert (fa.launches, fab.launches) == before
    with torch.no_grad():  # no gradient wanted: the forward kernel alone
        ops.attention_model_layout(q, k, v, causal=True, q_offset=8)
    assert fa.launches == before[0] + 1


def _train_params(cfg, st):
    """Float32 master weights on the CPU, from a seed."""
    return init_state(cfg, st, get_optimizer("sgd"), TrainConfig(),
                      torch.Generator().manual_seed(0), "cpu")["params"]


# norm-relative, per leaf: float32 sums in another order; bf16 activations
# rounded by cuBLAS and the kernels where the CPU rounds them the other way
GRAD_CLASS = {"float32": "f32_chain", "bfloat16": "bf16_chain"}


def _assert_grads_agree(got, want, dtype):
    rtol = TOLERANCES[GRAD_CLASS[dtype]][0]
    for (path, gt), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        assert gt is not None and gt.device.type == "cuda", path
        rel = ((gt.cpu().double() - w.double()).norm() / w.double().norm()).item()
        assert rel <= rtol, f"{path}: relative error {rel} over {GRAD_CLASS[dtype]}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_backward_on_cuda_matches_cpu(cuda, dtype):
    """The fault this guards against: the forward kernel's output carried no
    gradient, so loss.backward() on the card left wq (and wk, wv and their
    biases) without one.  The reduced qwen, float32 master weights, one
    batch: every parameter's gradient on the card against the CPU's."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 16).with_(dtype=dtype)
    st = get_strategy("2d_finalized")
    cpu = _train_params(cfg, st)
    gpu = tree_map(lambda p: p.detach().to(cuda).requires_grad_(), cpu)
    batch = {k: torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 128)))
             for k in ("tokens", "labels")}
    fab.launches = 0
    api.loss_fn(cfg, st, gpu, {k: v.to(cuda) for k, v in batch.items()}).backward()
    assert fab.launches == cfg.num_layers
    api.loss_fn(cfg, st, cpu, batch).backward()
    _assert_grads_agree(tree_map(lambda p: p.grad, gpu), tree_map(lambda p: p.grad, cpu), dtype)
    assert all(p.grad is not None for p in leaves(gpu))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_train_step_on_cuda_matches_cpu(cuda, dtype):
    """Two layers of qwen1.5-0.5b at full width: value_and_grad and one
    Adafactor step of make_train_step on the card against the same on the
    CPU (loss and grad norm; gradients per leaf)."""
    cfg = get_config("qwen1.5-0.5b").with_(num_layers=2, dtype=dtype)
    st = get_strategy("2d_finalized")
    cpu = _train_params(cfg, st)
    gpu = tree_map(lambda p: p.detach().to(cuda).requires_grad_(), cpu)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 129))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:])}
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    loss_g, grads_g = value_and_grad(cfg, st, gpu, gbatch)
    loss_c, grads_c = value_and_grad(cfg, st, cpu, batch)
    _assert_grads_agree(grads_g, grads_c, dtype)
    kind = "f32_chain" if dtype == "float32" else "bf16_round"
    assert_close(loss_g, loss_c, kind)
    opt = get_optimizer("adafactor")
    metrics = []
    for params, b in ((gpu, gbatch), (cpu, batch)):
        state = {"params": params, "opt": opt.init(params), "step": 0}
        metrics.append(make_train_step(cfg, st, opt, TrainConfig())(state, b)[1])
    for key in ("loss", "grad_norm"):
        assert_close(metrics[0][key], metrics[1][key], kind, err_msg=key)


# ---------------------------------------------------------------------------------
# the partitioner on a simulated (2,4) mesh, every device's shard on the card
# ---------------------------------------------------------------------------------


def _mesh():
    from repro_torch.core import Mesh

    return Mesh.create((2, 4), ("x", "y"))


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "f32_chain"),
                                        (torch.bfloat16, "bf16_chain")])
def test_partitioned_quickstart_mlp_on_cuda_matches_unsharded(cuda, dtype, kind):
    """The quickstart's MLP through spmd_partition at its default device
    (the card) against the same function unsharded on the card."""
    from repro_torch.core import annotate, mesh_split
    from repro_torch.core.partitioner import spmd_partition

    mesh = _mesh()

    def mlp(x, w1, w2):
        x = annotate(x, mesh_split(2, mesh, ["x", -1]))
        w1 = annotate(w1, mesh_split(2, mesh, [-1, "y"]))
        return torch.relu(x @ w1) @ w2

    gen = torch.Generator().manual_seed(0)
    # weights scaled by fan-in: outputs of order one, as in a model
    x, w1, w2 = ((torch.randn(s, generator=gen) * scale).to(cuda, dtype)
                 for s, scale in (((64, 256), 1.0), ((256, 512), 256 ** -0.5),
                                  ((512, 128), 512 ** -0.5)))
    runner = spmd_partition(mlp, mesh, compile_plans=False)
    got = runner(x, w1, w2)
    assert got.device.type == cuda.type and got.dtype == dtype
    assert runner.fallbacks == [] and runner.collectives == {"all-reduce": 1}
    assert_close(got, mlp(x, w1, w2), kind)


@pytest.mark.parametrize("shape,kernel,stride,pad,dims", [
    ((2, 8, 32, 32), (16, 8, 3, 3), 1, 1, [-1, -1, "x", "y"]),
    ((2, 3, 48), (4, 3, 5), 2, 2, ["x", -1, "y"]),
])
def test_partitioned_halo_conv_on_cuda_matches_unsharded(cuda, monkeypatch, shape, kernel,
                                                         stride, pad, dims):
    """Spatial dims sharded across the mesh: halo exchange by ppermute on the
    card, against cuDNN's unsharded convolution (TF32 off on both)."""
    import torch.nn.functional as F

    from repro_torch.core import annotate, mesh_split
    from repro_torch.core.partitioner import spmd_partition

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    mesh = _mesh()
    conv = F.conv2d if len(shape) == 4 else F.conv1d

    def f(x, w):
        return conv(annotate(x, mesh_split(len(shape), mesh, dims)), w, stride=stride,
                    padding=pad)

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(cuda)
    w = torch.randn(kernel, generator=gen).to(cuda)
    runner = spmd_partition(f, mesh, compile_plans=False)
    got = runner(x, w)
    assert runner.fallbacks == [] and set(runner.collectives) == {"collective-permute"}
    assert_close(got, f(x, w), "f32_chain")


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "f32_chain"),
                                        (torch.bfloat16, "bf16_round")])
def test_flash_op_on_cuda_launches_the_kernel_once(cuda, dtype, kind):
    """``repro_torch::flash_attention`` on CUDA tensors: one kernel launch,
    equal to the plain version on the same inputs."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((2, 256, 4, 2, 64), generator=gen).to(cuda, dtype)
    k, v = (torch.randn((2, 256, 4, 64), generator=gen).to(cuda, dtype) for _ in range(2))
    fa.launches = 0
    got = ops.flash_attention_op(q, k, v, True, 0, None, 128)
    torch.cuda.synchronize()
    assert fa.launches == 1
    assert_close(got, chunked_attention_ref(q, k, v, causal=True, chunk=128), kind)


def test_eager_attention_on_cuda_launches_the_kernel_without_the_operator(cuda, monkeypatch):
    """Eager no-grad attention on the card: one launch, straight to the
    kernel (the operator's dispatch is for capture only)."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((2, 128, 4, 2, 64), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((2, 128, 4, 64), generator=gen).to(cuda, torch.bfloat16)
            for _ in range(2))

    def refuse(*a, **kw):
        raise AssertionError("eager call went through the operator")

    monkeypatch.setattr(ops, "flash_attention_op", refuse)
    fa.launches = 0
    got = ops.attention_model_layout(q, k, v, causal=True, chunk=64)
    torch.cuda.synchronize()
    assert fa.launches == 1
    assert_close(got, chunked_attention_ref(q, k, v, causal=True, chunk=64), "bf16_round")


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "f32_chain"),
                                        (torch.bfloat16, "bf16_round")])
def test_partitioned_flash_op_on_cuda_folds_devices_into_one_launch(cuda, dtype, kind):
    """The op's partition handler on the card: q sharded on batch ("x") and kv
    heads ("y") and k/v on sequence (gathered), every device's attention in
    one launch, against the kernel unsharded."""
    from repro_torch.core import annotate, mesh_split
    from repro_torch.core.partitioner import spmd_partition

    mesh = _mesh()

    def f(q, k, v):
        q = annotate(q, mesh_split(5, mesh, ["x", -1, "y", -1, -1]))
        k = annotate(k, mesh_split(4, mesh, [-1, "y", -1, -1]))
        return ops.attention_model_layout(q, k, v, causal=True, chunk=128)

    gen = torch.Generator().manual_seed(3)
    q = torch.randn((4, 256, 8, 2, 64), generator=gen).to(cuda, dtype)
    k, v = (torch.randn((4, 256, 8, 64), generator=gen).to(cuda, dtype) for _ in range(2))
    want = f(q, k, v)
    for compile_plans in (True, False):
        runner = spmd_partition(f, mesh, compile_plans=compile_plans, optimize=False)
        fa.launches = 0
        got = runner(q, k, v)
        torch.cuda.synchronize()
        assert fa.launches == 1 and runner.fallbacks == []
        assert_close(got, want, kind)


def test_compiled_plan_on_cuda_equals_dynamic(cuda):
    """The quickstart MLP's compiled plan on the card, bit for bit the
    dynamic path's."""
    from repro_torch.core import annotate, mesh_split
    from repro_torch.core.partitioner import spmd_partition

    mesh = _mesh()

    def mlp(x, w1, w2):
        x = annotate(x, mesh_split(2, mesh, ["x", -1]))
        w1 = annotate(w1, mesh_split(2, mesh, [-1, "y"]))
        return torch.relu(x @ w1) @ w2

    gen = torch.Generator().manual_seed(4)
    args = [torch.randn(s, generator=gen).to(cuda) for s in ((64, 256), (256, 512), (512, 128))]
    compiled = spmd_partition(mlp, mesh, optimize=False)
    got = compiled(*args)
    assert compiled.collectives == {"all-reduce": 1}
    assert torch.equal(got, spmd_partition(mlp, mesh, compile_plans=False)(*args))


@pytest.mark.parametrize("dtype,kind", [("float32", "f32_chain"), ("bfloat16", "bf16_chain")])
def test_partitioned_decoder_layer_on_cuda_matches_unsharded(cuda, dtype, kind):
    """qwen's decoder layer at reduced width (4 heads on "model"),
    partitioned by compiled plan on ("data" 2, "model" 4) on the card: one
    flash launch per call, no fallback that gathers, equal to the layer
    unsharded on the card."""
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(dtype=dtype)
    st = get_strategy("2d_finalized")
    mesh = make_test_mesh()
    gen = torch.Generator(device="cuda").manual_seed(5)
    lp = tree_init(transformer.layer_param_tree(cfg, st), gen, dtype=dtype, device="cuda")
    x = torch.randn((4, 128, cfg.d_model), generator=gen, device="cuda").to(getattr(torch, dtype))
    positions = torch.arange(128, device="cuda").expand(4, 128)
    fn = transformer.partitionable_layer(cfg, st, mesh)
    want, _ = fn(lp, x, positions)
    runner = spmd_partition(fn, mesh, optimize=False)
    fa.launches = 0
    got, _ = runner(lp, x, positions)
    torch.cuda.synchronize()
    assert fa.launches == 1 and runner.fallback_gathers == []
    assert_close(got, want, kind)


def test_flash_operator_pair_at_the_partitioned_fold_matches_plain(cuda):
    """The differentiable flash operators at the partitioned train step's
    folded shape (8 devices x local batch 4, S 512, KR 4, Gl 1, D 64, bf16):
    the forward (one launch) with its log-sum-exp, and the backward (one
    call: three launches) against their plain versions."""
    q, k, v, do = _bwd_inputs(cuda, 32, 512, 4, 1, 64, torch.bfloat16, seed=6)
    fa.launches = fab.launches = 0
    out, lse = ops.flash_attention_fwd_op(q, k, v, True, 512)
    got = ops.flash_attention_bwd_op(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert (fa.launches, fab.launches) == (1, 1)
    assert_close(out, chunked_attention_ref(q, k, v, causal=True, chunk=512), "bf16_round")
    assert_close(lse, attention_lse_ref(q, k, causal=True), "f32_chain")
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for name, gt, w in zip("qkv", got, want):
        assert gt.dtype == torch.bfloat16 and bool(torch.isfinite(gt).all())
        assert_close(gt, w, BWD_TOL[torch.bfloat16], err_msg=f"d{name}")


def test_partitioned_train_step_on_cuda_matches_unsharded(cuda):
    """qwen at reduced width (d128, 4 heads of 32 on "model") cut to two
    layers, remat "none", bf16 compute with float32 masters: one Adafactor
    step of TrainLoop under set_mesh on ("data" 2, "model" 4) against the
    same step unsharded on the card.  Per step, one flash forward launch and
    one backward call per layer, all eight devices in each; no fallback that
    gathers; loss within bf16_chain, the step's update in norm within
    bf16_grad."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import TrainLoop

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(num_layers=2, remat="none",
                                                               scan_layers=False)
    st, opt, mesh = get_strategy("2d_finalized"), get_optimizer("adafactor"), make_test_mesh()
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 128, 8, seed=7, pattern="arithmetic"))
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, TrainConfig(), torch.Generator("cuda").manual_seed(7),
                            "cuda")
    runs = []
    for m in (mesh, None):
        params = tree_map(lambda p: p.detach().clone().requires_grad_(), state0["params"])
        state = {"params": params, "opt": opt.init(params), "step": 0}
        launched = []
        hooks = {"fault": lambda step: [setattr(mod, "launches", 0) for mod in (fa, fab)],
                 "metrics": lambda step, loss: launched.append((fa.launches, fab.launches))}
        with set_mesh(m):
            loop = TrainLoop(cfg, st, opt, TrainConfig(steps=1), pipe, hooks=hooks)
            state, losses = loop.run(initial_state=state)
        assert launched == [(2, 2)]
        runs.append((loop, state, losses))
    (loop, sharded, loss_s), (_, unsharded, loss_u) = runs
    assert loop.step_fn.runner.fallback_gathers == []
    assert_close(np.float32(loss_s[0]), np.float32(loss_u[0]), "bf16_chain")
    cat = lambda st_: torch.cat([(p - p0).flatten() for p, p0 in zip(
        leaves(st_["params"]), leaves(state0["params"])) if p.ndim >= 2])
    upd_s, upd_u = cat(sharded).double(), cat(unsharded).double()
    assert ((upd_s - upd_u).norm() / upd_u.norm()).item() <= TOLERANCES["bf16_grad"][0]


@pytest.mark.parametrize("B,S,H,hd,ds", [(4, 256, 3, 64, 128), (32, 2048, 6, 64, 128)])
def test_ssd_kernel_with_a_per_row_matches_plain(cuda, B, S, H, hd, ds):
    """A (Bb, H), one per batch row, as a partitioned call folds each
    device's heads into the batch: a small shape and the folded Mamba2 loss
    shape (eight devices' 4 rows of 6 heads).  The kernel against the plain
    version on the same per-row A within f32_chain; a shared A (H,) and the
    same A repeated over the rows give the same bits."""
    x, dt, Bm, Cm, _ = _ssd_inputs(cuda, B, S, H, hd, ds, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    A = -torch.rand(B, H, generator=g, device=cuda) - 0.05
    before = ssd_kernel.launches
    got = ssd_kernel.ssd_scan(x, dt, Bm, Cm, A, chunk=128)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    assert_close(got, ssd_scan_ref(x, dt, Bm, Cm, A, 128), "f32_chain")
    shared = ssd_kernel.ssd_scan(x, dt, Bm, Cm, A[0].contiguous(), chunk=128)
    rows = ssd_kernel.ssd_scan(x, dt, Bm, Cm, A[:1].expand(B, H).contiguous(), chunk=128)
    assert torch.equal(shared, rows)


# positions: 0 (one key: splits with none write empty partials), 1 and 2
# (fewer keys than splits), 63 and 64 (around a 64-key split share), the
# last but one of the cache
DECODE_POSITIONS = [0, 1, 2, 63, 64, 1022]


@pytest.mark.parametrize("B,KR", [(8, 16), (32, 4)])
def test_decode_with_the_position_on_the_device_matches_plain(cuda, B, KR):
    """The decode reads its position from an int32 on the card and sizes its
    splits by T: at the unsharded serve shape (B8 KR16 T1024) and the
    partitioned serve step's fold (B32 KR4 T1024), bf16, every position of
    DECODE_POSITIONS, one launch each, finite and within bf16_round of the
    plain version at the same position; the host never reads it."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(B, 1, KR, 1, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, 1024, KR, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    pl = fa.plan(B, 1, KR, 1, 1024, 64, torch.bfloat16, torch.bfloat16, causal=False,
                 q_offset=0, kv_len=1, position_on_device=True)
    assert pl.variant == "decode_splitkv" and pl.splits > 2
    for p in DECODE_POSITIONS:
        pos.fill_(p)
        before = fa.launches
        got = ops.flash_decode(q, k, v, pos, 1024)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert bool(torch.isfinite(got.float()).all()), p
        want = chunked_attention_ref(q, k, v, causal=False, chunk=1024, q_offset=p, kv_len=p + 1)
        assert_close(got, want, "bf16_round", err_msg=f"pos {p}")


def test_captured_decode_step_serves_two_positions_with_one_plan(cuda):
    """qwen at reduced width (d128, 4 heads and 4 kv heads on "model"), two
    layers, float32 compute on a bf16 cache: ``api.partitionable_decode``
    through ``spmd_partition`` on the card at two positions, one plan for
    both and one decode launch per layer per step (all eight devices in
    one), each step's logits within f32_chain of the unsharded eager step
    on the same inputs and its new cache within bf16_round (the new rows
    are float32 projections summed in another order, then rounded to
    bf16); no fallback that gathers."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(dtype="float32", num_layers=2)
    st, mesh = get_strategy("2d_finalized"), make_test_mesh()
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, st), torch.Generator("cuda").manual_seed(9),
                           dtype="float32", device="cuda")
        shapes = api.cache_shapes(cfg, st, 4, 64)
    g = torch.Generator(device=cuda).manual_seed(10)
    cache = {n: (torch.randn(s, generator=g, device=cuda) * 0.5).bfloat16() for n, s in shapes.items()}
    runner = spmd_partition(api.partitionable_decode(cfg, st, mesh), mesh, optimize=False,
                            device="cuda")
    for p in (5, 40):
        token = torch.randint(0, cfg.vocab_size, (4, 1), generator=g, device=cuda)
        pos = torch.tensor(p, dtype=torch.int32, device=cuda)
        before = fa.launches
        with torch.no_grad():
            logits, new = runner(params, token, cache, pos)
        torch.cuda.synchronize()
        assert fa.launches == before + cfg.num_layers
        with torch.no_grad():
            eager = {n: c.clone() for n, c in cache.items()}
            want, _ = api.decode_step(cfg, st, params, token, eager, pos)
        assert_close(logits, want, "f32_chain", err_msg=f"pos {p}")
        for n in cache:
            assert_close(new[n], eager[n], "bf16_round", err_msg=n)
    assert len(runner.plans) == 1 and runner.fallback_gathers == []


SHARD_POSITIONS = [0, 511, 512, 513, 1022]  # about a 512-key shard boundary


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_decode_at_per_row_positions_matches_plain(cuda, q_dtype):
    """The decode with one position per batch row and its log-sum-exp, at the
    fold of a sequence-sharded serve step (8 devices x 8 slots, KR 4, 512
    keys per device; the rows of the devices holding keys 512-1023 read the
    position less 512): one launch each, the output within bf16_round of
    ``flash_decode_partial_ref`` and the log-sum-exp within f32_chain; a row
    whose position lies before its shard writes output 0 and log-sum-exp
    -1e9, and no row is NaN."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, KR, T, D = 64, 4, 512, 64
    q = torch.randn(B, 1, KR, 1, D, generator=g, device=cuda).to(q_dtype)
    k, v = (torch.randn(B, T, KR, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    second = (torch.arange(B, device=cuda) // 8) >= 4  # devices (1, y) of the (2, 4) mesh
    for p in SHARD_POSITIONS:
        rows = (p - 512 * second.int()).to(torch.int32)
        before = fa.launches
        out, lse = ops.flash_decode_partial(q, k, v, rows, T)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert bool(torch.isfinite(out.float()).all()) and not bool(torch.isnan(lse).any())
        want, want_lse = flash_decode_partial_ref(q, k, v, rows, T)
        assert_close(out, want, "bf16_round", err_msg=f"pos {p}")
        assert_close(lse, want_lse, "f32_chain", err_msg=f"pos {p}")
        empty = rows < 0
        assert bool((out[empty] == 0).all()) and bool((lse[empty] == NEG_INF).all())


def test_sequence_sharded_decode_op_on_cuda_is_one_launch(cuda):
    """The decode op over k/v sharded on their sequence over "data"
    (compiled plan, bf16, 8 slots, 1024 keys): one launch for all eight
    devices, three all-reduces, the cache never gathered, and the result
    within bf16_round of the whole-cache plain decode on either side of the
    shard boundary."""
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import annotate_spec

    mesh = make_test_mesh()

    def fn(q, k, v, pos):
        k = annotate_spec(k, (None, "data", "model", None), mesh)
        v = annotate_spec(v, (None, "data", "model", None), mesh)
        return ops.flash_decode(q, k, v, pos, k.shape[1])

    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(8, 1, 16, 1, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(8, 1024, 16, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    runner = spmd_partition(fn, mesh, optimize=False, device="cuda")
    for p in SHARD_POSITIONS:
        before = fa.launches
        got = runner(q, k, v, torch.tensor(p, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert runner.collectives == {"all-reduce": 3} and runner.fallbacks == []
        want = chunked_attention_ref(q, k, v, causal=False, chunk=1024, q_offset=p, kv_len=p + 1)
        assert_close(got, want, "bf16_round", err_msg=f"pos {p}")


# ---------------------------------------------------------------------------------
# the SSD's backward kernel and Mamba2 training on the card
# ---------------------------------------------------------------------------------

# (B, S, H, hd, ds, chunk): the Mamba2 training call at one row, several
# chunks at both widths, one chunk (S = Q), ragged Q (36, 100), and hd 32
# with ds 16
SSD_BWD_CASES = [
    (1, 2048, 24, 64, 128, 128),
    (2, 512, 3, 64, 128, 128),
    (2, 256, 2, 32, 16, 64),
    (1, 128, 2, 64, 128, 128),
    (2, 144, 3, 64, 128, 36),
    (1, 100, 2, 32, 128, 128),
    (2, 192, 2, 64, 16, 48),
]
SSD_GRADS = ("dx", "ddt", "dB", "dC", "dA")


def _ssd_bwd_inputs(cuda, B, S, H, hd, ds, seed=0, per_row=False):
    x, dt, Bm, Cm, A = _ssd_inputs(cuda, B, S, H, hd, ds, seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 100)
    if per_row:
        A = -torch.rand(B, H, generator=g, device=cuda) - 0.05
    return x, dt, Bm, Cm, A, torch.randn(B, S, H, hd, generator=g, device=cuda)


def _assert_bwd_close(got, args, chunk):
    """Each gradient against the plain backward run in float64: in norm
    within f32_chain's rtol, and per element within 4x the plain float32
    version's own largest error (on signed inputs float32 itself lands up
    to 3x outside f32_chain per element, at near-zero sums of cancelling
    terms)."""
    want = ssd_scan_bwd_ref(*(t.double() for t in args), chunk)
    plain = ssd_scan_bwd_ref(*args, chunk)
    for name, g, w, p in zip(SSD_GRADS, got, want, plain):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.double() - w).abs()
        assert (err.norm() / w.norm()).item() <= TOLERANCES["f32_chain"][0], name
        assert err.max().item() <= 4 * (p.double() - w).abs().max().item(), name


@pytest.mark.parametrize("B,S,H,hd,ds,chunk", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_float64_plain(cuda, B, S, H, hd, ds, chunk):
    """dx, ddt, dB, dC and dA against the plain backward in float64
    (``_assert_bwd_close``): 3xTF32 products, and sums over heads, rows
    and chunks in a fixed order; one wrapper call per launch count."""
    args = _ssd_bwd_inputs(cuda, B, S, H, hd, ds)
    before = ssd_bwd_kernel.launches
    got = ssd_bwd_kernel.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_bwd_kernel.launches == before + 1
    _assert_bwd_close(got, args, chunk)


def test_ssd_backward_kernel_with_a_per_row_matches_plain(cuda):
    """A (Bb, H), as a partitioned call folds each device's heads into the
    batch: dA comes per row."""
    args = _ssd_bwd_inputs(cuda, 4, 512, 6, 64, 128, seed=1, per_row=True)
    got = ssd_bwd_kernel.ssd_scan_bwd(*args, chunk=128)
    assert got[4].shape == (4, 6)
    _assert_bwd_close(got, args, 128)


@pytest.mark.parametrize("B,S,H,hd,ds,chunk,per_row", [
    (1, 2048, 20, 64, 128, 128, False),  # the training widths at H 20: groups of 3, then 2
    (3, 576, 7, 64, 128, 36, True),      # Q 36: groups of 4, then 3
    (3, 500, 5, 32, 16, 50, True),       # Q 50, not a multiple of 4: groups of 2, then 1
])
def test_ssd_backward_kernel_with_a_short_last_head_group(cuda, B, S, H, hd, ds, chunk, per_row):
    """Head counts that the backward's head group does not divide, so that
    its last group is short: at the training widths, and with A per row at
    chunks that are no multiple of 16 (padded causal tiles; at Q 50 the dG
    scratch's rows are no multiple of 16 bytes)."""
    pl = ssd_bwd_kernel.plan(B, S, H, hd, ds, chunk, per_row,
                             sms=ssd_kernel.multiprocessors(cuda))
    assert H % pl.head_group, pl
    args = _ssd_bwd_inputs(cuda, B, S, H, hd, ds, seed=6, per_row=per_row)
    got = ssd_bwd_kernel.ssd_scan_bwd(*args, chunk=chunk)
    _assert_bwd_close(got, args, chunk)


def test_ssd_backward_kernel_takes_strided_views_and_repeats_bit_for_bit(cuda):
    """Head slices of wider x, dt, dy and A, and column slices of one B|C
    tensor; a second call gives the same bits (no atomics)."""
    x, dt, Bm, Cm, A, dy = _ssd_bwd_inputs(cuda, 2, 256, 6, 64, 128, seed=2)
    BC = torch.cat([Bm, Cm], dim=-1)
    views = (x[:, :, 1:4], dt[:, :, 1:4], BC[..., :128], BC[..., 128:], A[1:4], dy[:, :, 1:4])
    first, second = (ssd_bwd_kernel.ssd_scan_bwd(*views) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_bwd_close(first, [v.contiguous() for v in views], 128)


def test_ssd_backward_kernel_keeps_float32_accuracy_at_large_x(cuda):
    """x and dy scaled by 10^3 and x, B, C and dy taken non-negative: every
    gradient but ddt is then a sum of terms of one sign, held to f32_chain
    against float64; ddt adds A da to sums of the other sign, and is held,
    with the signed case (x * 10^3) on all five, to 4x the plain float32
    version's own largest error against float64."""
    x, dt, Bm, Cm, A, dy = _ssd_bwd_inputs(cuda, 2, 512, 3, 64, 128, seed=3)
    pos = (x.abs() * 1e3, dt, Bm.abs(), Cm.abs(), A, dy.abs() * 1e3)
    got = ssd_bwd_kernel.ssd_scan_bwd(*pos)
    want = ssd_scan_bwd_ref(*(t.double() for t in pos), 128)
    plain = ssd_scan_bwd_ref(*pos, 128)
    for name, g, w, p in zip(SSD_GRADS, got, want, plain):
        if name != "ddt":
            assert_close(g, w, "f32_chain", err_msg=name)
        kernel_err = (g.double() - w).abs().max().item()
        plain_err = (p.double() - w).abs().max().item()
        assert kernel_err <= 4 * plain_err, (name, kernel_err, plain_err)
    signed = (x * 1e3, dt, Bm, Cm, A, dy)
    got = ssd_bwd_kernel.ssd_scan_bwd(*signed)
    want = ssd_scan_bwd_ref(*(t.double() for t in signed), 128)
    plain = ssd_scan_bwd_ref(*signed, 128)
    for name, g, w, p in zip(SSD_GRADS, got, want, plain):
        kernel_err = (g.double() - w).abs().max().item()
        plain_err = (p.double() - w).abs().max().item()
        assert 0 < plain_err and kernel_err <= 4 * plain_err, (name, kernel_err, plain_err)


def test_ssd_gradient_through_the_kernels_matches_autograd_of_the_plain_version(cuda):
    """loss.backward() through ops.ssd on CUDA tensors that require grad (the
    forward kernel, then the backward kernel: one call each) against
    autograd through the plain forward in float64."""
    x, dt, Bm, Cm, A, dy = _ssd_bwd_inputs(cuda, 2, 384, 3, 64, 128, seed=4)
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A)]
    before = (ssd_kernel.launches, ssd_bwd_kernel.launches)
    (ops.ssd(*leaves, chunk=128) * dy).sum().backward()
    torch.cuda.synchronize()
    assert (ssd_kernel.launches, ssd_bwd_kernel.launches) == (before[0] + 1, before[1] + 1)
    ref = [t.double().requires_grad_() for t in (x, dt, Bm, Cm, A)]
    (ssd_scan_ref(*ref, 128) * dy.double()).sum().backward()
    for name, t, r in zip(SSD_GRADS, leaves, ref):
        rel = ((t.grad.double() - r.grad).norm() / r.grad.norm()).item()
        assert rel <= TOLERANCES["f32_chain"][0], (name, rel)


def test_ssd_gradient_the_kernel_does_not_cover_raises(cuda):
    """hd 48 is outside the kernels' widths: a call that needs the gradient
    raises before any launch, the direct backward too, and the forward
    wrapper called alone with such inputs refuses to detach them."""
    x, dt, Bm, Cm, A, dy = _ssd_bwd_inputs(cuda, 1, 128, 2, 64, 128)
    x48 = x[..., :48].contiguous().requires_grad_()
    before = (ssd_kernel.launches, ssd_bwd_kernel.launches)
    with pytest.raises(ValueError, match="hd, ds"):
        ops.ssd(x48, dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="hd, ds"):
        ssd_bwd_kernel.ssd_scan_bwd(x48.detach(), dt, Bm, Cm, A, dy[..., :48].contiguous())
    with pytest.raises(RuntimeError, match="backward"):
        ssd_kernel.ssd_scan(x.clone().requires_grad_(), dt, Bm, Cm, A)
    assert (ssd_kernel.launches, ssd_bwd_kernel.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_loss_backward_on_cuda_matches_cpu(cuda, dtype):
    """The reduced Mamba2 (three layers, d96), float32 master weights, one
    batch: every parameter's gradient on the card (the SSD's through its
    backward kernel, one call per layer) against the CPU's (autograd
    through the plain version), per leaf in norm; bf16 within bf16_grad,
    since random-weight bf16 Mamba2 amplifies rounding (R6)."""
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(dtype=dtype, remat="none")
    st = get_strategy("2d_finalized")
    cpu = _train_params(cfg, st)
    gpu = tree_map(lambda p: p.detach().to(cuda).requires_grad_(), cpu)
    batch = {k: torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)))
             for k in ("tokens", "labels")}
    ssd_bwd_kernel.launches = 0
    api.loss_fn(cfg, st, gpu, {k: v.to(cuda) for k, v in batch.items()}).backward()
    assert ssd_bwd_kernel.launches == cfg.num_layers
    api.loss_fn(cfg, st, cpu, batch).backward()
    rtol = TOLERANCES["f32_chain" if dtype == "float32" else "bf16_grad"][0]
    for (path, g), (_, w) in zip(leaves_with_paths(tree_map(lambda p: p.grad, gpu)),
                                 leaves_with_paths(tree_map(lambda p: p.grad, cpu))):
        rel = ((g.cpu().double() - w.double()).norm() / w.double().norm()).item()
        assert rel <= rtol, f"{path}: relative error {rel}"


def test_optimized_gradient_plan_on_cuda_equals_unoptimized(cuda):
    """mamba2-130m at reduced width (d128, 4 heads on "model") cut to two
    layers in float32: the partitioned train step's gradient program,
    captured and completed once, its plan compiled unoptimized and optimized
    (``plan_opt``, priced by a pinned profile), each run on the card on the
    same inputs: loss and every gradient leaf equal bit for bit (the SSD's
    kernels and the fixed-order collectives repeat bit for bit), and the
    same SSD forward and backward launches per call."""
    from repro_torch.analysis.roofline import RooflineParams
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan import compile_plan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import sharded_value_and_grad

    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(
        dtype="float32", num_layers=2, d_model=128, scan_layers=False)
    st, mesh = get_strategy("2d_finalized"), make_test_mesh()
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, st), torch.Generator("cuda").manual_seed(5),
                           dtype="float32", device="cuda")
        runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh, optimize=False)
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 65)))
    batch = {"tokens": tok[:, :-1].cuda(), "labels": tok[:, 1:].cuda()}
    params = tree_map(torch.Tensor.detach, params)

    def run():
        for mod in (ssd_kernel, ssd_bwd_kernel):
            mod.launches = 0
        loss, grads = runner(params, batch)
        return [loss] + leaves(grads), (ssd_kernel.launches, ssd_bwd_kernel.launches)

    want, want_launches = run()
    again, _ = run()
    assert all(torch.equal(a, b) for a, b in zip(want, again)), "the unoptimized plan repeats"
    (entry,) = runner.plans.values()
    with set_mesh(mesh):
        entry.plan = compile_plan(entry.captured, entry.prop, mesh, optimize=True,
                                  profile=RooflineParams(peak_flops=1e15, hbm_bw=3e12,
                                                         ici_bw=4.5e11, collective_launch_s=2e-5,
                                                         overlap_efficiency=0.0))
    got, got_launches = run()
    assert got_launches == want_launches and want_launches[1] == cfg.num_layers
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert entry.plan.opt_report.steps_after < entry.plan.opt_report.steps_before


def test_scan_node_on_cuda_under_capture(cuda):
    """The scan node (``core/scan.py``) on CUDA tensors with the card's
    torch: captured with a gradient recorded through it (one ``scan_fwd``
    node, its gradient one reverse ``scan`` node), the graph run on the card
    equal to the eager loop within f32 (values and the gradients of the
    consts, the carry and the xs), and the same program partitioned on the
    simulated mesh (a scan call step with its body plan) equal to it
    within f32_chain, compiled and dynamic."""
    import collections

    from repro_torch.core import Mesh, annotate, mesh_split
    from repro_torch.core.compat import capture
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.scan import scan

    mesh = Mesh.create((2, 4), ("x", "y"))
    g = torch.Generator(device=cuda).manual_seed(11)
    W, x0, c = (torch.randn(s, generator=g, device=cuda) for s in ((3, 16, 16), (8, 16), (16,)))

    def body(carry, w, c):
        w = annotate(w, mesh_split(2, mesh, [-1, "y"]))
        h = torch.tanh(carry @ w + c)
        return h, h.sum(-1)

    def prog(W, x0, c):
        W, x0, c = (t.detach().requires_grad_() for t in (W, x0, c))
        with torch.enable_grad():
            h, ys = scan(body, annotate(x0, mesh_split(2, mesh, ["x", -1])), W, consts=(c,))
            loss = h.sum() + (ys * ys).sum()
            return (loss, ys) + torch.autograd.grad(loss, [W, x0, c])

    want = prog(W, x0, c)
    cap = capture(prog, W, x0, c)
    ops_ = collections.Counter(str(n.target) for n in cap.graph.nodes if n.op == "call_function")
    assert (ops_["repro_torch.scan_fwd.default"], ops_["repro_torch.scan.default"]) == (1, 1)
    for a, b in zip(cap.gm(W, x0, c), want):
        assert a.is_cuda
        assert_close(a, b, "f32")
    for compiled in (True, False):
        runner = spmd_partition(prog, mesh, compile_plans=compiled, optimize=False)
        for a, b in zip(runner(W, x0, c), want):
            assert_close(a, b, "f32_chain")
        if compiled:
            (entry,) = runner.plans.values()
            assert [s.op for s in entry.plan.steps].count("scan") == 2


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_scanned_gradient_program_on_cuda_equals_unrolled(cuda, arch):
    """The partitioned train step's gradient program at reduced width (d128,
    4 heads on "model") cut to two layers, float32, remat "dots", with the
    layer loop scanned and unrolled, on the card: the same kernel launches
    per call (qwen: 4 flash forward, 2 backward; Mamba2: 4 SSD forward, 2
    backward, all eight devices in each) and the same values: Mamba2 bit for
    bit (its kernels repeat bit for bit), qwen within f32_chain (the flash
    backward sums dq in another order run to run)."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import sharded_value_and_grad

    cfg = reduced_config(get_config(arch), 8).with_(dtype="float32", num_layers=2, remat="dots")
    if arch == "mamba2-130m":
        cfg = cfg.with_(d_model=128)
    st, mesh = get_strategy("2d_finalized"), make_test_mesh()
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, st), torch.Generator("cuda").manual_seed(5),
                           dtype="float32", device="cuda")
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 65)))
    batch = {"tokens": tok[:, :-1].cuda(), "labels": tok[:, 1:].cuda()}
    params = tree_map(torch.Tensor.detach, params)
    mods = (fa, fab, ssd_kernel, ssd_bwd_kernel)
    runs = []
    for scan_layers in (True, False):
        c = cfg.with_(scan_layers=scan_layers)
        with set_mesh(mesh):
            runner = spmd_partition(sharded_value_and_grad(c, st, mesh), mesh, optimize=False)
        runner(params, batch)
        for mod in mods:
            mod.launches = 0
        loss, grads = runner(params, batch)
        torch.cuda.synchronize()
        runs.append(([loss] + leaves(grads), tuple(mod.launches for mod in mods)))
        if scan_layers:
            (entry,) = runner.plans.values()
            assert len(entry.plan.body_plans()) == 2 and runner.fallback_gathers == []
    (scanned, launched_s), (unrolled, launched_u) = runs
    want = (4, 2, 0, 0) if arch == "qwen1.5-0.5b" else (0, 0, 4, 2)
    assert launched_s == launched_u == want
    for a, b in zip(scanned, unrolled):
        if arch == "mamba2-130m":
            assert torch.equal(a, b)
        else:
            assert_close(a, b, "f32_chain")


# -- the kernel operators' vmap rules (the §3.3 pipeline's stage body) ---------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmapped_flash_operators_fold_the_stages_into_one_launch(cuda, dtype):
    n, B, S, KR, Gl, D = 4, 2, 256, 2, 2, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(n, B, S, KR, Gl, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(n, B, S, KR, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(n, B, S, KR, Gl, D, generator=g, device=cuda).to(dtype)
    before = fa.launches
    out = torch.func.vmap(lambda a, b, c: ops.flash_attention_op(a, b, c, True, 0, None, 128))(
        q, k, v)
    out2, lse = torch.func.vmap(lambda a, b, c: ops.flash_attention_fwd_op(a, b, c, True, 128))(
        q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 2  # one launch per vmapped call, for every stage
    before = fab.launches
    grads = torch.func.vmap(lambda *t: ops.flash_attention_bwd_op(*t, True))(
        q, k, v, out2, lse, do)
    torch.cuda.synchronize()
    assert fab.launches == before + 1
    for s in range(n):
        want = chunked_attention_ref(q[s], k[s], v[s], causal=True, chunk=128)
        assert_close(out[s], want, TOL[dtype])
        assert_close(out2[s], want, TOL[dtype])
        assert_close(lse[s], attention_lse_ref(q[s], k[s], causal=True), "f32_chain")
        for name, got, w in zip("qkv", grads, flash_attention_bwd_ref(
                q[s], k[s], v[s], out2[s], lse[s], do[s], causal=True)):
            assert_close(got[s], w, BWD_TOL[dtype], err_msg=f"stage {s} d{name}")


@pytest.mark.parametrize("a_per_row", [False, True])
def test_vmapped_ssd_operators_fold_the_stages_into_one_launch(cuda, a_per_row):
    n, B, S, H, hd, ds = 3, 2, 256, 4, 64, 128
    stages = [_ssd_inputs(cuda, B, S, H, hd, ds, seed=s) for s in range(n)]
    x, dt, Bm, Cm, A = (torch.stack(t) for t in zip(*stages))
    if a_per_row:
        A = A[:, None, :].expand(n, B, H).contiguous()
    dy = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(9), device=cuda)
    before = ssd_kernel.launches, ssd_bwd_kernel.launches
    y = torch.func.vmap(lambda *t: ops.ssd_scan_op(*t, 128))(x, dt, Bm, Cm, A)
    grads = torch.func.vmap(lambda *t: ops.ssd_scan_bwd_op(*t, 128))(x, dt, Bm, Cm, A, dy)
    torch.cuda.synchronize()
    assert (ssd_kernel.launches, ssd_bwd_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert tuple(grads[4].shape) == tuple(A.shape)
    for s in range(n):
        assert_close(y[s], ssd_scan_ref(x[s], dt[s], Bm[s], Cm[s], A[s], 128), "f32_chain")
        # against the float64 plain backward, in norm (the backward kernel's gate)
        want = ssd_scan_bwd_ref(*(t[s].double() for t in (x, dt, Bm, Cm, A, dy)), 128)
        for name, got, w in zip(("dx", "ddt", "dB", "dC", "dA"), grads, want):
            rel = ((got[s].double() - w).norm() / w.norm()).item()
            assert rel <= TOLERANCES["f32_chain"][0], f"stage {s} {name}: {rel}"


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_pipelined_loss_launches_one_kernel_call_per_layer_and_tick(cuda, arch):
    """``pipelined_loss_fn`` eagerly on the card (2 stages, 2 microbatches, 4
    layers, float32): one forward and one backward kernel call per layer of
    a stage and tick, for every stage at once (3 ticks of 2 layers), and
    the loss within f32_chain of the unpipelined ``loss_fn``."""
    from repro_torch.pipeline import PipelineDecision, pipelined_loss_fn, stage_stack_params

    over = {"d_model": 128} if arch == "mamba2-130m" else {}
    cfg = reduced_config(get_config(arch), 8).with_(num_layers=4, dtype="float32",
                                                    remat="none", **over)
    st = get_strategy("2d_finalized")
    params = tree_init(api.param_tree(cfg, st), torch.Generator("cuda").manual_seed(3),
                       dtype="float32", device="cuda")
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 257)))
    batch = {"tokens": tok[:, :-1].cuda(), "labels": tok[:, 1:].cuda()}
    staged = tree_map(lambda p: p.detach().requires_grad_(),
                      {**params, "layers": stage_stack_params(params["layers"], 2)})
    mods = (fa, fab) if arch == "qwen1.5-0.5b" else (ssd_kernel, ssd_bwd_kernel)
    for mod in mods:
        mod.launches = 0
    loss = pipelined_loss_fn(cfg, st, staged, batch, PipelineDecision("stage", 2, 2))
    grads = torch.autograd.grad(loss, leaves(staged))
    torch.cuda.synchronize()
    assert tuple(mod.launches for mod in mods) == (6, 6)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        want = api.loss_fn(cfg.with_(scan_layers=False), st, params, batch)
    assert_close(loss.detach(), want, "f32_chain")


# ---------------------------------------------------------------------------------
# checkpoints of tensors on the card
# ---------------------------------------------------------------------------------


def _card_state(cuda):
    """float32 params (one of them bf16), an int32 leaf and the int step,
    from a seeded generator on the card."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn((32, 64), generator=gen, device=cuda),
              "h": torch.randn((16, 8), generator=gen, device=cuda).bfloat16(),
              "b": torch.randn((64,), generator=gen, device=cuda)}
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "idx": torch.arange(12, dtype=torch.int32, device=cuda), "step": 5}


def test_checkpoint_of_card_tensors_restores_bit_equal(cuda, tmp_path):
    """CUDA tensors (bf16 included) saved and restored onto the card equal
    the originals bit for bit; the restored params need no grad."""
    from repro_torch.train import checkpoint as ckpt

    state = _card_state(cuda)
    ckpt.save(str(tmp_path), 1, state)
    restored, manifest = ckpt.restore(str(tmp_path), state)
    assert {l["key"]: l["dtype"] for l in manifest["leaves"]}["params/h"] == "bfloat16"
    for (path, got), want in zip(leaves_with_paths(restored), leaves(state)):
        if isinstance(want, torch.Tensor):
            assert got.device.type == "cuda" and got.dtype == want.dtype, path
            assert torch.equal(got, want.detach()), path
            assert not got.requires_grad, path
        else:
            assert got == want
    assert ckpt.verify_dir(str(tmp_path))["ok"]


def test_restore_resharded_with_sharded_reads_lands_on_the_card(cuda, tmp_path):
    """A state saved with (2,4) specs, restored onto (4,2) and onto a
    replicated target by per-device slice reads: every leaf on the card,
    bit-equal, no grad."""
    from repro_torch.core.sharding import Mesh, mesh_split
    from repro_torch.train import checkpoint as ckpt

    state = _card_state(cuda)
    src = Mesh.create((2, 4), ("data", "model"))
    ckpt.save(str(tmp_path), 1, state, specs={"params/w": mesh_split(2, src, ["data", "model"])})
    cpu_target = tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, state)
    new = Mesh.create((4, 2), ("data", "model"))
    for specs in ({"params/w": ("data", "model"), "params/b": ("model",)}, None):
        restored, _, report = ckpt.restore_resharded(str(tmp_path), cpu_target, new, specs,
                                                     sharded_io=True, device=cuda)
        assert report["io"]["bytes_read"] == report["io"]["full_bytes"]
        for (path, got), want in zip(leaves_with_paths(restored), leaves(state)):
            if isinstance(want, torch.Tensor):
                assert got.device.type == "cuda" and not got.requires_grad, path
                assert torch.equal(got, want.detach()), path
    assert report["resharded_leaves"] == 1  # the replicated target gathers w


# -- the autoshard search behind spmd_partition(autoshard=) -------------------------


def test_autoshard_gradient_program_on_cuda_matches_cpu(cuda):
    """qwen1.5-0.5b's loss and gradient at reduced width (d128, 4 heads) cut
    to two scanned layers, float32, with no mesh set and no annotation,
    through ``spmd_partition(autoshard=)`` on a simulated (2, 4) mesh: the
    searched plan on the card equals the same runner on the CPU within
    f32_chain, with one flash forward and one backward launch a layer for
    all eight devices."""
    from repro_torch.autoshard import AutoshardConfig
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(
        dtype="float32", num_layers=2, remat="none", scan_layers=True)
    st, mesh = get_strategy("2d_finalized"), make_test_mesh()
    params = tree_init(api.param_tree(cfg, st), torch.Generator("cpu").manual_seed(5),
                       dtype="float32", device="cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 65)))
    batch = {"labels": tok[:, 1:], "tokens": tok[:, :-1]}

    def program(p, b):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        with torch.enable_grad():
            return value_and_grad(cfg, st, live, b)

    config = AutoshardConfig(top_n=2, sa_steps=2, max_candidates=6)
    outs = {}
    for device in ("cpu", "cuda"):
        runner = spmd_partition(program, mesh, autoshard=config, process_cache=False,
                                device=device)
        runner(params, batch)
        fa.launches = fab.launches = 0
        loss, grads = runner(params, batch)
        torch.cuda.synchronize()
        outs[device] = [loss] + leaves(grads)
        if device == "cuda":
            assert (fa.launches, fab.launches) == (2, 2)
            assert runner.fallback_gathers == []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert_close(a, b, "f32_chain")


# -- elastic recovery: the coordinator's shrink on the card -------------------------


def test_elastic_device_loss_on_cuda_matches_cpu(cuda, tmp_path):
    """``ElasticCoordinator`` on a simulated world of 8 (model_parallel 2)
    with qwen1.5-0.5b at reduced width (d128, 4 heads) cut to two scanned
    layers, float32: four devices lost at step 3, so (4, 2) -> (2, 2) with
    one restore, and every step on the card launches 2 flash forward and 2
    backward calls; the losses within coarse of the same schedule on the
    CPU, from one initial state (a step-0 checkpoint)."""
    from repro_torch.core.plan import GuardConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.elastic import ElasticCoordinator, FaultInjector
    from repro_torch.autoshard import AutoshardConfig
    from repro_torch.train import checkpoint as ckpt

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(
        dtype="float32", num_layers=2, remat="none", scan_layers=True)
    st, opt = get_strategy("2d_finalized"), get_optimizer("adafactor", lr=0.05)
    state = init_state(cfg, st, opt, TrainConfig(), torch.Generator("cpu").manual_seed(5), "cpu")
    runs = {}
    for device in ("cpu", "cuda"):
        d = str(tmp_path / device)
        ckpt.save(d, 0, state, extra={"data_cursor": 0})
        tc = TrainConfig(steps=6, ckpt_dir=d, ckpt_every=2, log_every=1000,
                         guard=GuardConfig(rewind_after=2))
        co = ElasticCoordinator(
            cfg, st, opt, tc, TokenPipeline(DataConfig(cfg.vocab_size, 32, 8, seed=7,
                                                       pattern="arithmetic")),
            n_devices=8, model_parallel=2, injector=FaultInjector(device_loss_at=3, lose=4),
            autoshard_config=AutoshardConfig(top_n=2, sa_steps=2, max_candidates=6),
            max_recoveries=2, device=device)
        counts, fault, metrics = {}, co.loop.hooks["fault"], co.loop.hooks["metrics"]

        def reset(step, fault=fault):
            fa.launches = fab.launches = 0
            fault(step)

        def read(step, loss, metrics=metrics, counts=counts):
            torch.cuda.synchronize()
            counts[step] = (fa.launches, fab.launches)
            metrics(step, loss)

        co.loop.hooks.update(fault=reset, metrics=read)
        _, losses = co.run()
        runs[device] = (co, losses, counts)
    co, losses, counts = runs["cuda"]
    (ev,) = co.recoveries
    assert ev["mesh"] == {"from": [4, 2], "to": [2, 2]} and ev["restored_from"] == 2
    assert sorted(counts) == list(range(6))
    assert all(c == (2, 2) for c in counts.values()), counts
    assert co.loop.step_fn.runner.fallback_gathers == []
    assert_close(np.array(losses), np.array(runs["cpu"][1]), "coarse")
