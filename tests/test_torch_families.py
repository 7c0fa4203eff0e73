"""Every model family of the port against the reference: the registry and
parameter layout of all 11 archs, each new layer's forward and gradients,
every family's loss, and one MoE FL round through both engines.

Parameters and inputs are numpy draws (``_np_params``: matrices N(0, 0.2),
norm weights 1 + N(0, 0.1), biases N(0, 0.1), Mamba's A_log log U[1, 16]),
so that biases and norm weights are not trivial; both packages get the same
arrays.  The tiny family configs are the reference's own
(``tests/test_models.py``), in f32.  The reference programs compile once
each at XLA's optimization level 0 without the fusion emitters
(``quick_jit``).

Tolerances, f32 throughout (the frameworks sum matmuls, norms and softmax
in different orders, and the reference's attention is an online softmax
over KV chunks, the port's one softmax):
- layer outputs and losses: |port - ref| <= 1e-5 |ref| + 1e-6 max|ref|
  per tensor (a relative error plus an absolute one at a fraction of the
  tensor's scale, for elements that cancel; a loss is one element, so
  rtol 2e-5 in effect);
- gradients: |port - ref| <= 1e-4 |ref| + 1e-5 max|ref| per leaf;
- MoE routing (``gate_idx``, ``keep``) exactly equal, ties included;
- the FL round: loss rtol 1e-5, ledger exact, params and EF residuals at
  engine scope (DESIGN.md §6): rtol 1e-4 / atol 1e-6 on >= 99.9% of each
  leaf's elements, the updated supports overlapping >= 99%.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RJ
from repro.core.simulate import make_sim_step as make_sim_step_jax
from repro.core.types import FLConfig as FLConfigJax
from repro.models import layers as LJ
from repro.models import ssm as SJ
from repro.models.model import Model as ModelJax
from repro_torch.configs import registry as RT
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.simulate import make_sim_step
from repro_torch.core.types import ArchConfig, FLConfig
from repro_torch.models import layers as LT
from repro_torch.models import ssm as ST
from repro_torch.models.model import Model
from test_models import _cfgs as jax_family_cfgs
from test_torch_engine import _flat_t, _port_batch, _port_state, \
    _same_ledger, _tree_np

B, S = 2, 12


def quick_jit(fn):
    """``jax.jit`` at XLA's optimization level 0 and without the CPU
    backend's fusion emitters, for reference programs whose bits are not
    compared: without the emitters the gradients of the whole models
    compile several times faster than under ``test_torch_jaxkeys``'s
    ``quick_jit``."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False})


def port_cfg(cj):
    """The reference's ArchConfig as the port's (same fields, f32)."""
    kw = {f.name: getattr(cj, f.name) for f in dataclasses.fields(ArchConfig)}
    kw["dtype"] = torch.float32
    return ArchConfig(**kw)


FAMILIES = jax_family_cfgs()


def _np_params(defs, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in defs.items():
        if d.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.standard_normal(d.shape)
        elif d.init == "alog":
            a = np.log(rng.uniform(1.0, 16.0, d.shape))
        else:
            a = 0.2 * rng.standard_normal(d.shape)
        out[name] = a.astype(np.float32)
    return out


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return out


def _pt(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(a, e, what, rtol=1e-5, of_scale=1e-6):
    """|a - e| <= rtol |e| + of_scale max|e|, elementwise."""
    a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
    scale = float(np.abs(e).max()) if e.size else 0.0
    bad = np.abs(a - e) > rtol * np.abs(e) + of_scale * scale
    assert not bad.any(), (what, float(np.abs(a - e).max()), scale)


def _grad_close(a, e, what):
    _close(a, e, what, rtol=1e-4, of_scale=1e-5)


def _port_grads(fn, tensors):
    """``fn(*tensors)`` -> (outputs, gradients of its first output, a
    scalar, w.r.t. every tensor)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    grads = torch.autograd.grad(out[0], leaves)
    return [o.detach() for o in out], [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# registry and layout
# ---------------------------------------------------------------------------

def _paths(mj):
    return [".".join(str(getattr(k, "key", k)) for k in path) for path, _
            in jax.tree_util.tree_flatten_with_path(mj.abstract_params())[0]]


def test_registry_configs_match_reference():
    """All 11 archs: the ids, aliases and every field of CONFIG and SMOKE
    (dtype by name), the two properties SSM blocks read."""
    assert RT.ARCH_IDS == RJ.ARCH_IDS and RT._ALIAS == RJ._ALIAS
    for alias in RJ._ALIAS:
        assert RT.get_arch(alias).name == RJ.get_arch(alias).name
    for arch in RJ.ARCH_IDS:
        for get_t, get_j in ((RT.get_arch, RJ.get_arch),
                             (RT.get_smoke, RJ.get_smoke)):
            ct, cj = get_t(arch), get_j(arch)
            for f in dataclasses.fields(ArchConfig):
                vt, vj = getattr(ct, f.name), getattr(cj, f.name)
                if f.name == "dtype":
                    vt, vj = str(vt).removeprefix("torch."), \
                        jnp.dtype(vj).name
                assert vt == vj, (arch, ct.name, f.name, vt, vj)
            assert (ct.d_inner, ct.ssm_heads) == (cj.d_inner, cj.ssm_heads)
    with pytest.raises(KeyError, match="unknown arch"):
        RT.get_arch("no_such_arch")


def test_layouts_match_reference_and_convert_round_trips():
    """Every arch's CONFIG and SMOKE, and the tiny families: leaf names and
    shapes in ``jax.tree.leaves`` order and the parameter count, from defs
    only (nothing allocated).  ``params_to_jax`` / ``params_from_jax``
    carry each tiny family's tree (the encoder, ``patch_proj``, the
    multi-entry hybrid) both ways in the reference's structure."""
    cfgs = [(get_t(a), get_j(a)) for a in RJ.ARCH_IDS
            for get_t, get_j in ((RT.get_arch, RJ.get_arch),
                                 (RT.get_smoke, RJ.get_smoke))]
    cfgs += [(port_cfg(cj), cj) for cj in FAMILIES.values()]
    for ct, cj in cfgs:
        mt, mj = Model(ct), ModelJax(cj)
        assert list(mt.defs) == _paths(mj), ct.name
        assert [d.shape for d in mt.defs.values()] == \
            [tuple(a.shape) for a in jax.tree.leaves(mj.abstract_params())]
        assert mt.param_count() == mj.param_count(), ct.name
    jamba = Model(RT.get_arch("jamba_1_5_large_398b"))
    assert {k.split(".")[1] for k in jamba.defs if k.startswith("layers.")} \
        == {f"b{i}" for i in range(8)}
    assert Model(RT.get_arch("mamba2_370m")).param_count() == 419_825_152
    for family, cj in FAMILIES.items():
        mt, mj = Model(port_cfg(cj)), ModelJax(cj)
        tree = params_to_jax(_pt(_np_params(mt.defs, 0)))
        assert jax.tree.structure(tree) == \
            jax.tree.structure(mj.abstract_params()), family
        back = params_from_jax(tree)
        assert list(back) == list(mt.defs), family


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_ref(cf):
    """The reference's moe_block at capacity factor ``cf``: (y, aux), the
    gradient of sum(y * w) + aux w.r.t. the layer's params and x, and its
    routing (``lax.top_k`` of the f32 router probabilities and the
    capacity mask, as ``layers.moe_block`` computes them)."""
    cfg = dataclasses.replace(FAMILIES["moe"], expert_capacity_factor=cf)
    E, K = cfg.num_experts, cfg.experts_per_token

    def f(p, x, w):
        y, aux = LJ.moe_block(p, x, cfg)
        return jnp.sum(y * w) + aux, (y, aux)

    def route(p, x):
        h = LJ.rmsnorm(x, p["ln"], cfg.norm_eps)
        probs = jax.nn.softmax((h @ p["router"]).astype(jnp.float32), -1)
        _, gate_idx = jax.lax.top_k(probs, K)
        sel = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
        pos = jnp.cumsum(sel.sum(2), axis=1) - sel.sum(2)
        cap = max(1, int(cfg.expert_capacity_factor * x.shape[1] * K / E))
        return h, gate_idx, pos < cap

    return cfg, quick_jit(jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)), quick_jit(route)


@pytest.mark.parametrize("cf,zero_router", [(8.0, False), (1.0, False),
                                            (1.0, True)],
                         ids=["cf8", "drop", "zero_router"])
def test_moe_block_matches_reference(cf, zero_router):
    """Capacity factor 8 (nothing dropped), 1 (tokens dropped past
    capacity) and a zero router (every probability ties; ``lax.top_k``
    takes the lower experts, which then overflow)."""
    cfg_j, vg, route = _moe_ref(cf)
    cfg = port_cfg(cfg_j)
    pnp = _np_params(LT.moe_defs(cfg), 1)
    if zero_router:
        pnp["router"] = np.zeros_like(pnp["router"])
    x, w = _randn(2, B, S, cfg.d_model), _randn(3, B, S, cfg.d_model)
    (_, (y_j, aux_j)), (g_p, g_x) = vg(_nest(pnp), jnp.asarray(x),
                                       jnp.asarray(w))
    names = list(pnp)
    wt = torch.from_numpy(w)

    def f(x_, *ps):
        y, aux = LT.moe_block(dict(zip(names, ps)), x_, cfg)
        return (y * wt).sum() + aux, y, aux

    (_, y_t, aux_t), grads = _port_grads(
        f, [torch.from_numpy(x)] + list(_pt(pnp).values()))
    _close(y_t, y_j, "moe y")
    _close(aux_t, aux_j, "moe aux")
    _grad_close(grads[0], g_x, "moe grad x")
    for name, g in zip(names, grads[1:]):
        _grad_close(g, g_p[name], f"moe grad {name}")
    h_j, idx_j, keep_j = route(_nest(pnp), jnp.asarray(x))
    _, idx_t, _, _, keep_t = LT.moe_route(torch.from_numpy(np.array(h_j)),
                                          _pt(pnp)["router"], cfg)
    idx_j, keep_j = np.asarray(idx_j), np.asarray(keep_j)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    routed = (idx_j[..., None] == np.arange(cfg.num_experts)).any(2)
    assert (routed & ~keep_j).any() == (cf < 8.0)
    if zero_router:
        assert (idx_t.numpy() == np.arange(cfg.experts_per_token)).all()


@functools.lru_cache(maxsize=None)
def _ssm_ref():
    cfg = FAMILIES["ssm"]

    def f(p, x, w, xs, dt, A, Bm, Cm, D, w2):
        y = SJ.mamba_block(p, x, cfg)
        ys = [SJ.ssd_chunked(xs, dt, A, Bm, Cm, D, c) for c in (4, 12)]
        return (jnp.sum(y * w) + sum(jnp.sum(v * w2) for v in ys),
                (y, *ys))

    return cfg, quick_jit(jax.value_and_grad(f, argnums=tuple(range(9)),
                                             has_aux=True))


def test_mamba_block_and_ssd_match_reference():
    """``mamba_block`` at the ssm family's chunk 4 (three chunks of 12
    tokens), and ``ssd_chunked`` at chunks 4 and 12 (one chunk) on direct
    inputs: outputs and every gradient."""
    cfg_j, vg = _ssm_ref()
    cfg = port_cfg(cfg_j)
    pnp = _np_params(ST.mamba_defs(cfg), 4)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, w = _randn(5, B, S, cfg.d_model), _randn(6, B, S, cfg.d_model)
    rng = np.random.default_rng(7)
    ssd_in = [_randn(8, B, S, H, P),
              rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32),
              -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
              _randn(9, B, S, 1, N), _randn(10, B, S, 1, N),
              _randn(11, H)]
    w2 = _randn(12, B, S, H, P)
    (_, outs_j), grads_j = vg(_nest(pnp), *map(jnp.asarray, [x, w] + ssd_in
                                                   + [w2]))
    names = list(pnp)
    wt, w2t = torch.from_numpy(w), torch.from_numpy(w2)

    def f(x_, xs, dt, A, Bm, Cm, D, *ps):
        y = ST.mamba_block(dict(zip(names, ps)), x_, cfg)
        ys = [ST.ssd_chunked(xs, dt, A, Bm, Cm, D, c) for c in (4, 12)]
        return ((y * wt).sum() + sum((v * w2t).sum() for v in ys), y, *ys)

    outs_t, grads_t = _port_grads(
        f, [torch.from_numpy(a) for a in [x] + ssd_in]
        + list(_pt(pnp).values()))
    for what, a, e in zip(("mamba_block", "ssd chunk 4", "ssd chunk 12"),
                          outs_t[1:], outs_j):
        _close(a, e, what)
    g_p, g_x, _, *g_ssd = grads_j
    _grad_close(grads_t[0], g_x, "mamba grad x")
    for what, a, e in zip(("xs", "dt", "A", "Bm", "Cm", "D"), grads_t[1:7],
                          g_ssd):
        _grad_close(a, e, f"ssd grad {what}")
    for name, g in zip(names, grads_t[7:]):
        _grad_close(g, g_p[name], f"mamba grad {name}")


# (causal, window, rope): the decoder's full and sliding-window masks, and
# the encoder's bidirectional attention without rope
ATTN_CASES = ((True, 0, True), (True, 5, True), (False, 0, False))


@functools.lru_cache(maxsize=None)
def _attn_ref():
    cfg = FAMILIES["dense"]                       # qkv_bias=True
    pos = jnp.arange(S)

    def f(p, x, w):
        outs = []
        h = LJ.rmsnorm(x, p["ln"], cfg.norm_eps)
        for causal, window, use_rope in ATTN_CASES:
            q, k, v = LJ._qkv(p, h, cfg, pos, use_rope=use_rope)
            outs.append(LJ.chunked_attention(
                q, k, v, q_positions=pos, k_positions=pos, causal=causal,
                window=window, chunk=5) @ p["wo"])
        return sum(jnp.sum(o * w) for o in outs), outs

    return cfg, quick_jit(jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True))


def test_attention_bias_window_and_bidirectional_match_reference():
    """QKV bias, rope, the causal, sliding-window (5) and non-causal masks
    against the reference's chunked online softmax (KV chunks of 5, the
    last one padded)."""
    cfg_j, vg = _attn_ref()
    cfg = port_cfg(cfg_j)
    defs = LT.attn_defs(cfg)
    assert {"bq", "bk", "bv"} <= set(defs)
    pnp = _np_params(defs, 13)
    x, w = _randn(14, B, S, cfg.d_model), _randn(15, B, S, cfg.d_model)
    (_, outs_j), (g_p, g_x) = vg(_nest(pnp), jnp.asarray(x), jnp.asarray(w))
    names = list(pnp)
    wt = torch.from_numpy(w)
    pos = torch.arange(S)

    def f(x_, *ps):
        p = dict(zip(names, ps))
        outs = []
        h = LT.rmsnorm(x_, p["ln"], cfg.norm_eps)
        for causal, window, use_rope in ATTN_CASES:
            q, k, v = LT.qkv(p, h, cfg, pos, use_rope=use_rope)
            outs.append(LT.attention(q, k, v, causal=causal,
                                     window=window) @ p["wo"])
        return (sum((o * wt).sum() for o in outs), *outs)

    outs_t, grads = _port_grads(f, [torch.from_numpy(x)]
                                + list(_pt(pnp).values()))
    for case, a, e in zip(ATTN_CASES, outs_t[1:], outs_j):
        _close(a, e, f"attention {case}")
    _grad_close(grads[0], g_x, "attention grad x")
    for name, g in zip(names, grads[1:]):
        _grad_close(g, g_p[name], f"attention grad {name}")


@functools.lru_cache(maxsize=None)
def _cross_ref():
    cfg = FAMILIES["encdec"]

    def f(pc, pm, x, enc, w):
        y = LJ.cross_attention(pc, x, LJ.encode_cross_kv(pc, enc, cfg), cfg)
        y = LJ.mlp_block(pm, y, cfg)
        return jnp.sum(y * w), y

    return cfg, quick_jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                             has_aux=True))


def test_cross_attention_and_gelu_mlp_match_reference():
    """Whisper's decoder tail: cross-attention over 8 encoder frames (no
    mask, no rope, no bias) and the ungated tanh-gelu MLP."""
    cfg_j, vg = _cross_ref()
    cfg = port_cfg(cfg_j)
    pc = _np_params(LT.cross_attn_defs(cfg), 16)
    pm = _np_params(LT.mlp_defs(cfg, gated=False), 17)
    assert "bq" not in pc and "w_gate" not in pm
    T = cfg.frontend_tokens
    x, enc, w = (_randn(18, B, S, cfg.d_model), _randn(19, B, T, cfg.d_model),
                 _randn(20, B, S, cfg.d_model))
    (_, y_j), (gc_j, gm_j, gx_j, ge_j) = vg(
        _nest(pc), _nest(pm), jnp.asarray(x), jnp.asarray(enc),
        jnp.asarray(w))
    nc, nm = list(pc), list(pm)
    wt = torch.from_numpy(w)

    def f(x_, enc_, *ps):
        p_c, p_m = dict(zip(nc, ps[:len(nc)])), dict(zip(nm, ps[len(nc):]))
        y = LT.cross_attention(p_c, x_, LT.encode_cross_kv(p_c, enc_, cfg),
                               cfg)
        y = LT.mlp_block(p_m, y, cfg)
        return (y * wt).sum(), y

    (_, y_t), grads = _port_grads(
        f, [torch.from_numpy(x), torch.from_numpy(enc)]
        + list(_pt(pc).values()) + list(_pt(pm).values()))
    _close(y_t, y_j, "cross + gelu mlp")
    _grad_close(grads[0], gx_j, "grad x")
    _grad_close(grads[1], ge_j, "grad encoder output")
    for name, g in zip(nc, grads[2:2 + len(nc)]):
        _grad_close(g, gc_j[name], f"grad cross {name}")
    for name, g in zip(nm, grads[2 + len(nc):]):
        _grad_close(g, gm_j[name], f"grad mlp {name}")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    b = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
         "mask": mask}
    if cfg.family == "vlm":
        b["patches"] = _randn(seed + 1, B, cfg.num_patches, cfg.d_model)
    if cfg.family == "encdec":
        b["frontend"] = _randn(seed + 2, B, cfg.frontend_tokens, cfg.d_model)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


GRAD_FAMILIES = ("moe", "encdec")


def test_family_losses_match_reference():
    """Every tiny family's ``loss_fn``: the total, ``xent`` and ``aux``
    (the router loss summed over superblocks; 0 without experts).  The
    two with gradients below are checked there."""
    for family, cj in FAMILIES.items():
        if family in GRAD_FAMILIES:
            continue
        mt, mj = Model(port_cfg(cj)), ModelJax(cj)
        pnp, b = _np_params(mt.defs, 21), _batch(cj)
        loss_j, m_j = quick_jit(lambda p, b_: mj.loss(p, b_, chunk=8))(
            _nest(pnp), {k: jnp.asarray(v) for k, v in b.items()})
        with torch.no_grad():
            loss_t, m_t = mt.loss(_pt(pnp), _torch_batch(b), chunk=8)
        _close(loss_t, loss_j, f"{family} loss")
        _close(m_t["xent"], m_j["xent"], f"{family} xent")
        _close(m_t["aux"], m_j["aux"], f"{family} aux")
        assert (float(m_t["aux"]) > 0) == bool(cj.num_experts), family


@pytest.mark.parametrize("family", GRAD_FAMILIES)
def test_loss_value_and_grad_match_reference(family):
    """The whole loss, ``xent``, ``aux`` and the gradient w.r.t. every
    leaf: the MoE stack (router aux included) and the encoder-decoder
    (the encoder's leaves reached through cross-attention)."""
    cj = FAMILIES[family]
    mt, mj = Model(port_cfg(cj)), ModelJax(cj)
    pnp, b = _np_params(mt.defs, 22), _batch(cj)
    (loss_j, m_j), g_j = quick_jit(jax.value_and_grad(
        lambda p, b_: mj.loss(p, b_, chunk=8), has_aux=True))(
            _nest(pnp), {k: jnp.asarray(v) for k, v in b.items()})
    leaves = {k: v.requires_grad_(True) for k, v in _pt(pnp).items()}
    loss_t, m_t = mt.loss(leaves, _torch_batch(b), chunk=8)
    g_t = torch.autograd.grad(loss_t, list(leaves.values()))
    _close(loss_t.detach(), loss_j, f"{family} loss")
    _close(m_t["xent"].detach(), m_j["xent"], f"{family} xent")
    aux_t = torch.as_tensor(m_t["aux"]).detach()
    _close(aux_t, m_j["aux"], f"{family} aux")
    assert (float(aux_t) > 0) == bool(cj.num_experts), family
    flat_j = jax.tree.leaves(g_j)
    assert len(flat_j) == len(g_t)
    for (name, g), e in zip(zip(leaves, g_t), flat_j):
        _grad_close(g.numpy(), e, f"{family} grad {name}")


# ---------------------------------------------------------------------------
# the slice as a whole: one MoE FL round
# ---------------------------------------------------------------------------

FL_CLIENTS, FL_SEQ, FL_BATCH = 4, 16, 2
FL_KW = dict(uplink_compressor="topk:0.1>>qsgd:8", local_steps=1,
             local_lr=0.2)


def _fl_batch(vocab, seed=24):
    """A round's batch in ``data.synthetic.sample_round``'s layout, drawn
    with numpy (the reference's sampler compiles for seconds)."""
    rng = np.random.default_rng(seed)
    shape = (FL_CLIENTS, FL_BATCH, FL_SEQ)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
            "mask": np.ones(shape, np.float32),
            "sizes": rng.uniform(1.0, 2.0, FL_CLIENTS).astype(np.float32),
            "resources": rng.uniform(0.05, 1.0, (FL_CLIENTS, 4)).astype(
                np.float32)}


def test_moe_fl_round_matches_reference_engine():
    """One sim round of the MoE family (4 clients, E = 1, lr 0.2, EF
    ``topk:0.1>>qsgd:8``) through the port's engine (``make_sim_step``,
    plain backend) against the reference engine's round from the same
    state and batch; the reference's QSGD uniforms reach the port through
    ``JaxKey``."""
    cj = FAMILIES["moe"]
    mj, mt = ModelJax(cj), Model(port_cfg(cj))
    sim_j = make_sim_step_jax(mj, FLConfigJax(backend="jax", **FL_KW),
                              FL_CLIENTS, chunk=FL_SEQ)
    sim_t = make_sim_step(mt, FLConfig(backend="jax", **FL_KW), FL_CLIENTS,
                          chunk=FL_SEQ, device="cpu")
    assert sim_t.terms == sim_j.terms
    # numpy params (the reference's N(0, 0.02) init gives every router
    # probability nearly 1/E, and its draws compile for seconds)
    pnp, b = _np_params(mt.defs, 23), _fl_batch(cj.vocab_size)
    mj.init = lambda rng: _nest(pnp)
    st_j = sim_j.init_fn(jax.random.PRNGKey(0))
    st_t = _port_state(sim_t, st_j)
    new_j, m_j = quick_jit(sim_j.engine.round_fn)(
        st_j, {k: jnp.asarray(v) for k, v in b.items()})
    new_t, m_t = sim_t.step_fn(st_t, _port_batch(b))
    assert new_t.round == int(new_j.round) == 1
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    _same_ledger(m_t["ledger"], m_j["ledger"])
    for (name, a), e, p in zip(new_t.params.items(), _tree_np(new_j.params),
                               pnp.values()):
        a = a.numpy()
        close = np.isclose(a, e, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (name, close.mean())
        s_t, s_j = a != p, e != p
        assert (s_t & s_j).sum() / max(1, int((s_t | s_j).sum())) >= 0.99, \
            name
    res_t, res_j = _flat_t(new_t.comm_state), _tree_np(new_j.comm_state)
    assert len(res_t) == len(res_j) == len(mt.defs)
    for a, e in zip(res_t, res_j):
        close = np.isclose(a.numpy(), e, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, ("EF residual", close.mean())
