"""The port on the card: the CUDA flash-attention (forward and backward)
and SSD-scan kernels against their plain PyTorch versions, and the serving,
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
from repro_torch.kernels.ref import (
    attention_lse_ref, attention_ref, chunked_attention_ref, flash_attention_bwd_ref,
    ssd_recurrence, ssd_scan_ref,
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
