"""The port's MoE family (``models/moe.py``, MoE superblocks in
``models/transformer.py``) against the JAX package's, on the same weights
(the reference's ``tree_init`` carried across with ``params_from_numpy``)
and the same seeded numpy inputs, in float32:

* ``moe_forward`` with routing by rows and pooled routing, with drops
  (capacity factor 1.25) and without (4.0), within f32_chain;
* reduced granite-moe-1b-a400m and llama4-maverick-400b-a17b (superblocks
  of two, a shared expert, top 1): param trees, cache shapes and specs, the
  loss and its gradients under ``jax.value_and_grad``, decode steps with
  their caches, and greedy engine steps;
* the partitioned MoE loss and gradient under moe_2d on a simulated (2, 4)
  mesh against the reference's unsharded ones: the dispatch lowered to
  AllToAlls, no fallback that gathers;
* the routing ops' rules: a sharded batch dim kept, only the operated dim
  gathered.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.layers import tree_init as jax_tree_init
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.annotate import annotate
from repro_torch.core.compat import assert_close, capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.propagation import propagate
from repro_torch.core.sharding import Sharding
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api, moe, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import tree_map_params, tree_shapes
from repro_torch.serve.engine import Engine, Request
from repro_torch.train.loop import sharded_value_and_grad, value_and_grad

ST, JST = get_strategy("moe_2d"), jax_get_strategy("moe_2d")
MESH = make_test_mesh()
ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]


def _cfgs(arch, reduce=16, **over):
    """The reduced config in both packages, float32, the layer loop unrolled
    on the reference's side (its scan compiles the stack otherwise)."""
    jcfg = jax_reduced_config(jax_get_config(arch), reduce).with_(dtype="float32", **over)
    cfg = reduced_config(get_config(arch), reduce).with_(dtype="float32", **over)
    return jcfg.with_(scan_layers=False), cfg


def _params(jcfg, cfg, seed=0, skew=0.0):
    """Both packages' params from the reference's ``tree_init``; ``skew`` is
    added to the routers' column of expert 0, so that it draws more than
    its capacity and assignments drop."""
    jp = jax_tree_init(jax_api.param_tree(jcfg, JST), jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.array, jp)
    if skew:
        np_tree["layers"]["moe"]["router"][..., 0] += skew
        jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jp, np_tree, params_from_numpy(np_tree, cfg, "cpu", ST, dtype="float32")


def _batch(cfg, B, S, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": tok[:, :-1].copy(), "labels": tok[:, 1:].copy()}


def _grads_close(grads, jgrads, kind="f32_chain"):
    flat = dict(leaves_with_paths(grads))
    jflat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(jflat)
    for path, want in jflat:
        key = tuple(k.key for k in path)
        assert_close(flat[key], np.asarray(want), kind, err_msg=f"grad {key}")


def _trim(spec):
    """A PartitionSpec as the port's plain tuple: trailing Nones dropped."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_config_param_trees_and_cache_shapes_match_reference():
    """Both MoE configs: param shapes (superblock keys, the router, experts
    with their leading E dim, llama4's shared expert) and cache shapes
    equal the reference's; the router is stored in float32 whatever the
    model dtype, as the reference reads it."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jshapes = jax.tree_util.tree_map(lambda d: tuple(d["shape"]),
                                         jax_api.param_tree(jcfg, JST), is_leaf=jax_layers.is_param)
        decl = api.param_tree(cfg, ST)
        assert tree_map_params(lambda d, _: d["shape"], decl) == jshapes, arch
        assert api.cache_shapes(cfg, ST, 2, 16) == jax_api.cache_shapes(jcfg, JST, 2, 16), arch
        stored = tree_shapes(decl, "bfloat16")
        routers = [t for path, t in leaves_with_paths(stored) if path[-1] == "router"]
        assert routers and all(t.dtype == torch.float32 for t in routers), arch
    jcfg, cfg = _cfgs("llama4-maverick-400b-a17b")
    assert transformer.superblock(cfg) == 2
    assert set(api.param_tree(cfg, ST)["layers"]) == {"0", "1"}
    assert set(api.param_tree(cfg, ST)["layers"]["1"]) == {"ln1", "attn", "ln2", "moe", "mlp"}
    assert api.cache_shapes(cfg, ST, 2, 16)["k"][:2] == (cfg.num_layers // 2, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_abstract_cache_match_reference(arch):
    """Under a (2, 4) mesh: ``api.cache_specs`` (llama4's with the
    superblock's extra leading dim unsharded) and ``api.abstract_cache``
    against the reference's under a device-free ``AbstractMesh``."""
    jcfg, cfg = _cfgs(arch)
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh((2, 4), ("data", "model"))):
        want_specs = {k: _trim(v) for k, v in jax_api.cache_specs(jcfg, JST).items()}
        want = jax_api.abstract_cache(jcfg, JST, 8, 64)
    with set_mesh(MESH):
        specs = api.cache_specs(cfg, ST)
        cache = api.abstract_cache(cfg, ST, 8, 64)
    assert specs == want_specs
    assert {k: tuple(t.shape) for k, t in cache.items()} == \
        {k: tuple(w.shape) for k, w in want.items()}
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in cache.values())


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_forward_matches_reference(pooled, capacity_factor):
    """One MoE layer (8 experts, top 2) on the same weights and input: rows
    of 24 tokens route by row; four rows of one token pool (S K < 2 E);
    expert 0 drawn more (``skew``), so that at capacity 1.25 some
    assignments drop (checked), at 4.0 none do."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m", num_experts=8, top_k=2,
                      capacity_factor=capacity_factor)
    jp, _, p = _params(jcfg, cfg, skew=0.5)
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    pm = tree_map(lambda t: t[0], p["layers"]["moe"])
    B, S = (4, 1) if pooled else (2, 24)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want, jaux = jax_moe.moe_forward(jcfg, JST, jm, jnp.asarray(x))
    got, aux = moe.moe_forward(cfg, ST, pm, torch.from_numpy(x))
    assert_close(got, np.asarray(want), "f32_chain")
    assert_close(aux, np.asarray(jaux), "f32_chain")
    # the routing groups and drops the case is about
    xr = torch.from_numpy(x).reshape(1, B * S, -1) if pooled else torch.from_numpy(x)
    *_, top_e = moe.route(cfg, pm, xr)
    flat = top_e.reshape(xr.shape[0], -1)
    kept = int((moe.slots(flat, cfg.num_experts) < moe.capacity(cfg, xr.shape[1])).sum())
    assert (kept < flat.numel()) == (capacity_factor == 1.25 and not pooled)


def test_slots_follow_token_order_within_each_expert():
    """The slot of each assignment is the count of earlier assignments (in
    token order) to its expert: the stable sort, searchsorted and inverse
    permutation against a plain count."""
    flat = torch.from_numpy(np.random.default_rng(2).integers(0, 5, (3, 40)))
    got = moe.slots(flat, 5)
    for b in range(3):
        seen = {}
        for i, e in enumerate(flat[b].tolist()):
            assert got[b, i].item() == seen.get(e, 0)
            seen[e] = seen.get(e, 0) + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, _, p = _params(jcfg, cfg)
    batch = _batch(cfg, 2, 32, 3)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jax_api.loss_fn(jcfg, JST, q, jb)))(jp)
    live = tree_map(lambda t: t.requires_grad_(), p)
    loss, grads = value_and_grad(cfg, ST, live, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_close(loss, np.asarray(jloss), "f32_chain")
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Five decode steps (pooled routing: 4 rows of one token) with their
    caches, llama4's in superblocks (L/2, 2, B, T, KR, D)."""
    jcfg, cfg = _cfgs(arch)
    jp, _, p = _params(jcfg, cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 5))
    shapes = api.cache_shapes(cfg, ST, 4, 16)
    jcache = {k: jnp.zeros(v, jnp.bfloat16) for k, v in shapes.items()}
    cache = {k: torch.zeros(v, dtype=torch.bfloat16) for k, v in shapes.items()}
    step = jax.jit(lambda q, t, c, pos: jax_api.decode_step(jcfg, JST, q, t, c, pos))
    for pos in range(5):
        tok = tokens[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(tok, jnp.int32), jcache, pos)
        got, cache = api.decode_step(cfg, ST, p, torch.from_numpy(tok), cache, pos)
        # coarse: the caches are bf16 in both (R10), and a value straddling
        # a bf16 rounding boundary lands an ulp apart
        assert_close(got, np.asarray(want), "coarse", err_msg=f"logits at {pos}")
        for name in ("k", "v"):
            assert_close(cache[name], np.asarray(jcache[name].astype(jnp.float32)),
                         "bf16_round", err_msg=f"cache {name} at {pos}")


def test_engine_greedy_tokens_match_reference():
    """Reduced granite behind both engines (3 slots, max_len 24, five
    requests of 4 new tokens): the same greedy tokens.  Pooled routing
    couples the slots (R5), so the whole batch is held, not single rows."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m", num_experts=8, top_k=2)
    jp, _, p = _params(jcfg, cfg)
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(3)] for i in range(5)]
    jeng = JaxEngine(jcfg, JST, jp, batch_slots=3, max_len=24)
    eng = Engine(cfg, ST, p, batch_slots=3, max_len=24)
    jreqs = jeng.generate([JaxRequest(prompt=q, max_new_tokens=4) for q in prompts])
    reqs = eng.generate([Request(prompt=q, max_new_tokens=4) for q in prompts])
    assert eng.pos == jeng.pos
    assert [r.out for r in reqs] == [r.out for r in jreqs]


@pytest.mark.parametrize("scan_layers", [False, True])
def test_partitioned_loss_and_grads_match_reference(scan_layers):
    """granite at reduced_config(.., 8) with 4 kv heads (so that the heads
    divide "model": no kv replication), 8 experts, top 2, capacity 4.0
    (the case is about sharding, not drops, as the reference's
    test_moe_sharded_parity): the partitioned step's loss and gradients
    under moe_2d on (2, 4) against the reference's unsharded
    ``jax.value_and_grad``; the dispatch's AllToAll over "data" in the plan
    for each MoE layer each way (forward and backward; a scanned stack's
    counted at trip count), and no fallback but rope's halves (slice and
    cat along the head dim, which keep the sharding and gather nothing)."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m", reduce=8, num_experts=8, top_k=2,
                      capacity_factor=4.0, num_kv_heads=4, remat="none")
    cfg = cfg.with_(scan_layers=scan_layers)
    jp, np_tree, _ = _params(jcfg, cfg, seed=5)
    with set_mesh(MESH):
        params = params_from_numpy(np_tree, cfg, "cpu", ST, dtype="float32")
        runner = spmd_partition(sharded_value_and_grad(cfg, ST, MESH), MESH, optimize=False,
                                device="cpu")
    batch = _batch(cfg, 4, 16, 6)
    loss, grads = runner(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jax_api.loss_fn(jcfg, JST, q, jb)))(jp)
    assert_close(loss, np.asarray(jloss), "f32_chain")
    _grads_close(grads, jgrads)
    (entry,) = runner.plans.values()
    a2a = moe.dispatch_alltoalls(entry.plan)
    assert a2a["to_experts"] >= 2 * cfg.num_layers and a2a["to_batch"] >= 2 * cfg.num_layers
    assert runner.collectives["all-to-all"] > 0
    assert runner.fallback_gathers == [] and set(runner.fallbacks) <= {"aten.slice", "aten.cat"}


def _routing_programs():
    """Each routing op on a (4, 8, 16) input, its batch dim annotated on
    "data" and its last dim on "model": the ops work along the last dim."""
    def sharded(x):
        return annotate(x, Sharding(MESH, (("data",), (), ("model",))))

    def softmax(x):
        return torch.softmax(sharded(x), dim=-1)

    def softmax_grad(x):  # a cotangent of x's sharding: no reduction over the batch
        x = sharded(x).detach().requires_grad_()
        with torch.enable_grad():
            y = torch.softmax(x, dim=-1)
            return torch.autograd.grad(y, x, grad_outputs=x.detach())[0]

    def topk(x):
        v, i = torch.topk(sharded(x), 3, dim=-1)
        return v, i

    def topk_grad(x):  # the gradient of topk is a scatter
        x = sharded(x).detach().requires_grad_()
        with torch.enable_grad():
            v = torch.topk(x, 3, dim=-1)[0]
            return torch.autograd.grad(v, x, grad_outputs=v.detach())[0]

    def sort_stable(x):
        v, i = torch.sort(sharded(x), dim=-1, stable=True)
        return v, i

    def argsort(x):
        return torch.argsort(sharded(x), dim=-1)

    def searchsorted(x):
        seq = torch.sort(sharded(x), dim=-1, stable=True)[0]
        q = sharded(x * 0.5)
        return torch.searchsorted(seq, q.contiguous(), side="left")

    return {"softmax": softmax, "softmax_grad": softmax_grad, "topk": topk,
            "topk_grad": topk_grad, "sort_stable": sort_stable, "argsort": argsort,
            "searchsorted": searchsorted}


_OPS = {"softmax": "aten._softmax", "softmax_grad": "aten._softmax_backward_data",
        "topk": "aten.topk", "topk_grad": "aten.scatter", "sort_stable": "aten.sort",
        "argsort": "aten.sort", "searchsorted": "aten.searchsorted"}


@pytest.mark.parametrize("name", sorted(_routing_programs()))
def test_routing_ops_keep_the_batch_sharded_and_gather_only_the_operated_dim(name):
    """Each routing op alone on the simulated mesh: equal to the program
    unsharded (exact), no fallback; completion keeps the batch dim on
    "data" on the op's operands and results and leaves the results'
    operated dim whole (searchsorted's queries stay split); the only
    collectives gather "model" on the operated dim before the op."""
    from repro_torch.core.rules import lower, op_name

    f = _routing_programs()[name]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 8, 16)).astype(np.float32))
    runner = spmd_partition(f, MESH, optimize=False, device="cpu")
    got = runner(x)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(f(x))):
        assert torch.equal(g, w), name
    assert runner.fallbacks == []
    assert set(runner.collectives) == {"all-gather"}, runner.collectives
    captured = capture(f, x)
    prop = propagate(captured, MESH)
    nodes = [n for n in captured.graph.nodes
             if n.op == "call_function" and op_name(n) == _OPS[name]]
    assert nodes
    for node in nodes:
        eqn = lower(node)
        outs = [node] if eqn.out_avals else [o for o in eqn.tuple_outs if o is not None]
        for v in list(eqn.invars) + outs:
            sh = prop.get(v)
            assert sh is not None and sh.dims_mapping[0] == ("data",), (name, v, sh)
        if name != "searchsorted":  # its queries stay split
            assert all(prop.get(o).dims_mapping[-1] == () for o in outs), name


def test_routing_spy_records_forces_and_counts_flips():
    """``obs/routing.py``: a run made to take its own recorded routing gives
    the same loss bit for bit; another run's experts moved at one token
    count as one flip there, the row's prefix before it untouched."""
    from repro_torch.obs.routing import RoutingSpy, routing_flips, stacked

    from repro_torch.models.layers import tree_init

    _, cfg = _cfgs("granite-moe-1b-a400m", num_experts=8, top_k=2)
    p = tree_init(api.param_tree(cfg, ST), torch.Generator().manual_seed(9), dtype="float32",
                  device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16, 8).items()}
    rec = []
    with RoutingSpy(rec):
        loss = api.loss_fn(cfg, ST, p, batch)
    logits, experts = stacked(rec)
    assert experts.shape == (cfg.num_layers, 2, 16, cfg.top_k) and len(rec) == cfg.num_layers
    with RoutingSpy([], forced=experts):
        assert torch.equal(api.loss_fn(cfg, ST, p, batch), loss)
    moved = experts.clone()
    moved[1, 1, 5] = torch.tensor([e for e in range(8) if e not in experts[1, 1, 5]][:2])
    flips = routing_flips(logits, moved, logits, experts)
    assert flips["flips"] == 1 and flips["per_call"] == [0, 1]
    assert flips["first_flip_per_row"] == [16, 5]
    assert flips["max_margin_over_own_diff"] > 1.0  # the same logits: no sound flip
