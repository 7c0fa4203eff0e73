"""The serving slice against the reference: the online-softmax
``chunked_attention``, ``forward(window=, chunk=)`` and remat, the decode
caches (the KV ring buffer, the int8 KV cache, the Mamba state),
``decode_step``, ``prefill``, the serve CLI, ``configs/shapes.py``,
``optim/`` and the cache conversion.

The tiny family configs are the reference's own
(``tests/test_models.py:13-47``), copied, in f32.  Parameters are numpy
draws at the init's scales (matrices N(0, 0.02), norm weights 1 + N(0,
0.05), biases N(0, 0.02), Mamba's A_log log U[1, 16]) handed to both
packages (``convert.params_from_jax``); caches cross through
``convert.cache_from_jax``.  Each reference program compiles once at
XLA's optimization level 0 without the fusion emitters (``quick_jit``);
the bit-exact comparisons (the int8 codes, the optimizers) run the
reference op by op under ``jax.disable_jit()``.

Tolerances, f32 throughout (the frameworks sum matmuls, norms and
softmax in different orders):
- attention and the forward: ``assert_allclose`` rtol 2e-4, atol 2e-5,
  the reference's own dense comparison (``test_models.py:130``); against
  the port's plain ``attention`` atol 1e-5;
- decode against the reference: logits and every cache leaf within 1e-5
  (absolute), ``slot_pos`` exact; decode against the port's own forward
  5e-3, the window-4 ring buffer 2e-3, the int8 cache 0.05 (the
  reference's ``test_models.py:77``, ``:111``, ``:220``);
- remat, the int8 codes and scales, the optimizers, the cache
  conversion: bit for bit.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RJ
from repro.configs import shapes as SHJ
from repro.core.types import ArchConfig as ArchConfigJax
from repro.models import layers as LJ
from repro.models import model as MJ
from repro.optim import adamw as adamw_jax
from repro.optim import apply_updates as apply_updates_jax
from repro.optim import sgd as sgd_jax
from repro_torch import checkpoint
from repro_torch.configs import registry as RT
from repro_torch.configs import shapes as SHT
from repro_torch.convert import cache_from_jax, cache_to_jax, \
    params_from_jax
from repro_torch.core.types import ArchConfig
from repro_torch.launch import serve
from repro_torch.models import layers as LT
from repro_torch.models import model as MT
from repro_torch.models.model import Model
from repro_torch.optim import adamw, apply_updates, sgd

B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread (many small ops: OpenMP threads
    only slow them down when test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quick_jit(fn):
    """``jax.jit`` at XLA's optimization level 0 and without the CPU
    backend's fusion emitters (the values are compared within a
    tolerance, and these compile several times faster)."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False})


def _cfgs():
    """The reference's tiny family configs (``tests/test_models.py``)."""
    f32 = jnp.float32
    return {
        "dense": ArchConfigJax(
            name="d", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=97,
            block_pattern=("attn+mlp",), dtype=f32, remat=False,
            qkv_bias=True),
        "moe": ArchConfigJax(
            name="m", family="moe", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=96, vocab_size=97, num_experts=4,
            experts_per_token=2, expert_capacity_factor=8.0,
            block_pattern=("attn+moe",), dtype=f32, remat=False),
        "ssm": ArchConfigJax(
            name="s", family="ssm", num_layers=2, d_model=64, num_heads=0,
            vocab_size=97, ssm_state=16, ssm_head_dim=32, ssm_chunk=4,
            block_pattern=("mamba",), dtype=f32, remat=False),
        "hybrid": ArchConfigJax(
            name="h", family="hybrid", num_layers=4, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=97,
            num_experts=4, experts_per_token=2, expert_capacity_factor=8.0,
            ssm_state=16, ssm_head_dim=32, ssm_chunk=4,
            block_pattern=("mamba+mlp", "attn+moe"), dtype=f32,
            remat=False),
        "encdec": ArchConfigJax(
            name="e", family="encdec", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=97,
            encoder_layers=2, frontend_tokens=8,
            block_pattern=("attn+cross+mlp",), dtype=f32, remat=False),
        "vlm": ArchConfigJax(
            name="v", family="vlm", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=97, num_patches=8,
            block_pattern=("attn+mlp",), dtype=f32, remat=False),
    }


FAMILIES = _cfgs()


def port_cfg(cj, **kw):
    """The reference's ArchConfig as the port's (same fields, f32)."""
    d = {f.name: getattr(cj, f.name) for f in dataclasses.fields(ArchConfig)}
    d.update({"dtype": torch.float32, **kw})
    return ArchConfig(**d)


def _np_params(cfg, seed=0):
    """Flat numpy params of the port's ``param_defs`` at the init's
    scales, the norms and biases not trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in MT.param_defs(cfg).items():
        if d.init == "ones":
            a = 1.0 + 0.05 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.02 * rng.standard_normal(d.shape)
        elif d.init == "alog":
            a = np.log(rng.uniform(1.0, 16.0, d.shape))
        else:
            a = d.scale * rng.standard_normal(d.shape)
        out[name] = a.astype(np.float32)
    return out


def _nest(flat, fn=jnp.asarray):
    out = {}
    for key, v in flat.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = fn(v)
    return out


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
           "mask": np.ones((B, S), np.float32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(family, **kw):
    """(reference cfg, port cfg, reference params, port params, numpy
    batch) of a tiny family."""
    cj = dataclasses.replace(FAMILIES[family], **kw)
    ct = port_cfg(cj)
    flat = _np_params(ct)
    return cj, ct, _nest(flat), params_from_jax(_nest(flat, np.asarray)), \
        _batch(ct)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(a, e, what, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(e, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _np(t):
    return t.detach().cpu().numpy()


def _full_logits(params, batch, cfg, **kw):
    x, _ = MT.forward(params, _tb(batch), cfg, **kw)
    return MT.unembed(params, x, cfg)


def test_chunked_attention_against_reference_and_plain(monkeypatch):
    """Causal, windowed and bidirectional, keys padded to a chunk of 4 and
    13 queries to a chunk_q of 5: the reference's output within its own
    dense tolerance and the port's plain ``attention`` within 1e-5, with
    the query chunks in one tile and one a tile; the default positions
    (which skip the KV chunks a tile cannot see) bit-equal to explicit
    ones."""
    rng = np.random.default_rng(0)
    Sq, H, KV, hd = 13, 4, 2, 8
    q, k, v = (rng.standard_normal((B, Sq, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    pos = torch.arange(Sq)
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        ref = quick_jit(lambda q_, k_, v_: LJ.chunked_attention(
            q_, k_, v_, q_positions=jnp.arange(Sq), k_positions=jnp.arange(
                Sq), causal=causal, window=window, chunk=4, chunk_q=5))(
            q, k, v)
        plain = LT.attention(qt, kt, vt, causal=causal, window=window)
        for tile in (LT.TILE_ELEMS, B * H * 5 * 4):
            monkeypatch.setattr(LT, "TILE_ELEMS", tile)
            what = f"causal={causal} window={window} tile={tile}"
            out = LT.chunked_attention(qt, kt, vt, q_positions=pos,
                                       k_positions=pos, causal=causal,
                                       window=window, chunk=4, chunk_q=5)
            assert out.shape == (B, Sq, H * hd)
            _close(_np(out), ref, f"reference {what}")
            _close(_np(out), _np(plain), f"plain {what}", rtol=0, atol=1e-5)
            assert torch.equal(out, LT.chunked_attention(
                qt, kt, vt, causal=causal, window=window, chunk=4,
                chunk_q=5)), what


def test_forward_window_and_chunk_against_reference():
    """``forward(window=3, chunk=4)`` of every family but moe (which
    shares dense's attention and hybrid's MoE) against the reference."""
    for family in ("dense", "ssm", "hybrid", "encdec", "vlm"):
        cj, ct, pj, pt, batch = _both(family)
        window = 0 if family == "ssm" else 3
        ref, aux_ref = quick_jit(lambda p, b: MJ.forward(
            p, b, cj, window=window, chunk=4))(pj, batch)
        out, aux = MT.forward(pt, _tb(batch), ct, window=window, chunk=4)
        _close(_np(out), ref, family)
        if torch.is_tensor(aux):
            _close(_np(aux), aux_ref, f"{family} aux")


def test_remat_is_bit_identical(monkeypatch):
    """Remat on equals remat off bit for bit, in the loss and every
    gradient (superblocks, encoder layers and cross-entropy chunks
    rematerialised), and in chunked attention's output and gradients
    with its tiles rematerialised (13 queries in tiles of one 5-query
    chunk)."""
    monkeypatch.setattr(LT, "TILE_ELEMS", B * 4 * 5 * 4)
    rng = np.random.default_rng(2)
    qkv = [torch.from_numpy(rng.standard_normal((B, 13, n, 8)).astype(
        np.float32)) for n in (4, 2, 2)]
    out = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        o = LT.chunked_attention(*leaves, window=6, chunk=4, chunk_q=5,
                                 remat=remat)
        out.append([o.detach()] + list(torch.autograd.grad(
            (o * o).sum(), leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    for family in ("dense", "hybrid", "encdec"):
        _, ct, _, pt, batch = _both(family)
        out = []
        for remat in (False, True):
            cfg = dataclasses.replace(ct, remat=remat)
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in pt.items()}
            loss, _ = MT.loss_fn(leaves, _tb(batch), cfg, chunk=5)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out.append([loss.detach()] + list(grads))
        for a, b in zip(*out):
            assert torch.equal(a, b), family


def _decode_both(family, steps=S, **kw):
    """Steps the reference's decode and the port's from their own zero
    caches (the encoder's entries filled on each side), yielding the two
    logits and caches after every step."""
    cj, ct, pj, pt, batch = _both(family, **kw)
    enc_len = ct.frontend_tokens if ct.family == "encdec" else 0
    cache_j = MJ.init_cache(cj, B, S, enc_len=enc_len)
    cache_t = MT.init_cache(ct, B, S, enc_len=enc_len)
    if ct.family == "encdec":
        def fill(p, c, f):
            enc = MJ._encode(p, f, cj)

            def one(psb, csb):
                ek, ev = LJ.encode_cross_kv(psb["b0"]["cross"], enc, cj)
                return {"b0": {"kv": csb["b0"]["kv"],
                               "enc": {"ek": ek, "ev": ev}}}
            return jax.vmap(one)(p["layers"], c)
        cache_j = quick_jit(fill)(pj, cache_j, batch["frontend"])
        MT.encode_cache(pt, cache_t, torch.from_numpy(batch["frontend"]), ct)
    step = quick_jit(lambda p, c, t, pos: MJ.decode_step(p, c, t, pos, cj))
    for t in range(steps):
        tok = batch["tokens"][:, t:t + 1]
        lj, cache_j = step(pj, cache_j, tok, jnp.int32(t))
        lt, cache_t = MT.decode_step(pt, cache_t, torch.from_numpy(tok), t,
                                     ct)
        yield t, lj, cache_j, lt, cache_t


def test_decode_step_matches_reference_step_by_step():
    """dense, ssm, hybrid (Mamba + MoE) and encdec: logits and every cache
    leaf within 1e-5 at every step, ``slot_pos`` exact."""
    for family in ("dense", "ssm", "hybrid", "encdec"):
        for t, lj, cache_j, lt, cache_t in _decode_both(family):
            _close(_np(lt), lj, f"{family} logits t={t}", rtol=0, atol=1e-5)
            ref = cache_from_jax(jax.tree.map(np.asarray, cache_j))
            assert list(ref) == list(cache_t), family
            for name, r in ref.items():
                what = f"{family} cache {name} t={t}"
                assert cache_t[name].dtype == r.dtype, what
                if name.endswith("slot_pos"):
                    assert torch.equal(cache_t[name], r), what
                else:
                    _close(_np(cache_t[name]), _np(r), what, rtol=0,
                           atol=1e-5)


def _decode_errors(ct, pt, batch, cache, window=0, tensor_pos=False):
    full = _full_logits(pt, batch, ct, chunk=8)
    errs = []
    for t in range(S):
        pos = torch.tensor(t, dtype=torch.int32) if tensor_pos else t
        logits, cache = MT.decode_step(pt, cache, torch.from_numpy(
            batch["tokens"][:, t:t + 1]), pos, ct, window=window)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    return errs, cache


def test_decode_matches_forward():
    """The port's decode equals its own forward (``test_models.py:77``),
    with ``pos`` a Python int, and a 0-dim tensor where it reaches
    attention's ring write and the decoder's sinusoid."""
    for family in ("dense", "ssm", "hybrid", "encdec"):
        _, ct, _, pt, batch = _both(family)
        enc_len = ct.frontend_tokens if ct.family == "encdec" else 0
        modes = (False, True) if family in ("dense", "encdec") else (False,)
        for tensor_pos in modes:
            cache = MT.init_cache(ct, B, S, enc_len=enc_len)
            if ct.family == "encdec":
                MT.encode_cache(pt, cache, torch.from_numpy(
                    batch["frontend"]), ct)
            errs, _ = _decode_errors(ct, pt, batch, cache,
                                     tensor_pos=tensor_pos)
            assert max(errs) < 5e-3, (family, tensor_pos, errs)


def test_sliding_window_ring_buffer():
    """A 4-slot ring buffer with window 4 equals the forward at
    ``sliding_window=4`` (``test_models.py:111``); after 12 steps slot s
    holds the last position congruent to s mod 4."""
    _, ct, _, pt, batch = _both("dense", sliding_window=4, name="w")
    for tensor_pos in (False, True):
        cache = MT.init_cache(ct, B, 4)
        errs, cache = _decode_errors(ct, pt, batch, cache, window=4,
                                     tensor_pos=tensor_pos)
        assert max(errs) < 2e-3, errs
        want = torch.tensor([8, 9, 10, 11], dtype=torch.int32)
        assert torch.equal(cache["b0.kv.slot_pos"],
                           want.expand(ct.num_superblocks, 4))


def test_int8_kv_cache():
    """``_quantize_kv``'s codes equal the reference's op by op and its
    scales bit-equal, ties to even included; the int8 decode within 0.05
    of the exact forward (``test_models.py:220``)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, 2, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, -1.5, 2.5]     # x / s * 127 = .5 ties
    x[1, 0, 1] = 0.0                             # an all-zero head
    with jax.disable_jit():
        qj, sj = LJ._quantize_kv(jnp.asarray(x))
    qt, st = LT._quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st).view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    assert _np(qt)[0, 0, 0, 1] == 0 and _np(qt)[0, 0, 0, 2] == -2

    _, ct, _, pt, batch = _both("dense")
    cache = MT.init_cache(ct, B, S, quantized=True)
    assert cache["b0.kv.k"].dtype == torch.int8
    assert cache["b0.kv.kscale"].shape == (ct.num_superblocks, B, S, 2, 1)
    errs, _ = _decode_errors(ct, pt, batch, cache)
    assert max(errs) < 0.05, errs


def _jax_dtype(a):
    return np.dtype(a.dtype).name


def _torch_dtype(t):
    return str(t.dtype).split(".")[-1]


def test_smoke_decode_step_every_arch():
    """One decode step of every registered arch's ``SMOKE`` config: finite
    logits (B, 1, V), the cache's names, shapes and dtypes equal to
    ``jax.eval_shape`` of the reference's ``init_cache`` (nothing of the
    reference compiled), the cache's layout kept by the step."""
    for arch in RT.ARCH_IDS:
        ct, cj = RT.get_smoke(arch), RJ.get_smoke(arch)
        enc_len = ct.frontend_tokens if ct.family == "encdec" else 0
        for quantized in (False, True):
            ref = jax.eval_shape(lambda: MJ.init_cache(
                cj, B, 8, enc_len, quantized=quantized))
            flat = MT.cache_defs(ct, B, 8, enc_len, quantized)
            want = {".".join(str(k.key) for k in path):
                    (tuple(a.shape), _jax_dtype(a))
                    for path, a in jax.tree_util.tree_leaves_with_path(ref)}
            got = {k: (d.shape, str(d.dtype).split(".")[-1])
                   for k, d in flat.items()}
            assert got == want, (arch, quantized)
        model = Model(ct)
        params = model.init(0, "cpu")
        cache = model.init_cache(B, 8, enc_len=enc_len, device="cpu")
        shapes = {k: (v.shape, v.dtype) for k, v in cache.items()}
        logits, cache = model.decode(params, cache, torch.zeros(
            (B, 1), dtype=torch.int64), 0)
        assert logits.shape == (B, 1, ct.vocab_size), arch
        assert bool(torch.isfinite(logits).all()), arch
        assert {k: (v.shape, v.dtype) for k, v in cache.items()} == shapes


def test_prefill_against_reference():
    """``prefill`` (window 0, chunk 4) of dense and hybrid: the
    last-position logits (B, 1, V) within the reference's tolerance."""
    for family in ("dense", "hybrid"):
        cj, ct, pj, pt, batch = _both(family)
        ref = quick_jit(lambda p, b: MJ.prefill(p, b, cj, chunk=4))(
            pj, {"tokens": batch["tokens"]})
        out = Model(ct).prefill(pt, {"tokens": torch.from_numpy(
            batch["tokens"])}, chunk=4)
        assert out.shape == (B, 1, ct.vocab_size)
        _close(_np(out), ref, family)


def test_serve_cli_on_cpu(capsys, tmp_path):
    """``serve.main`` on paper_lm: the reference's lines, parsed; with
    ``--restore`` of a port checkpoint it serves the greedy tokens of the
    params it saved."""
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "4",
            "--steps", "4", "--cache-len", "16"]
    seqs = serve.main(args)
    out = capsys.readouterr().out
    assert seqs.shape == (2, 8)
    assert "arch=paper_lm served 2 seqs x 8 tokens" in out
    seq0 = re.search(r"seq0: ([\d ]+)", out).group(1).split()
    assert [int(v) for v in seq0] == seqs[0].tolist()
    assert re.search(r"compile\+first_step=[\d.]+ms", out)
    assert re.search(r"prefill: 2 steps mean=[\d.]+ms p95=[\d.]+ms", out)
    assert re.search(r"decode:  4 steps mean=[\d.]+ms p95=[\d.]+ms", out)
    assert re.search(r"throughput: [\d.]+ tokens/sec \(batch 2 x 4 warm",
                     out)

    model = Model(RT.get_arch("paper_lm"))
    params = model.init(5, "cpu")
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, params)
    restored = serve.main(args + ["--restore", path])
    g = torch.Generator()
    g.manual_seed(1)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 4), generator=g)
    cache = model.init_cache(2, 16, device="cpu")
    tok, toks = prompt[:, :1], [prompt[:, :1]]
    for t in range(7):
        logits, cache = model.decode(params, cache, tok, t)
        tok = prompt[:, t + 1:t + 2] if t < 3 else \
            torch.argmax(logits[:, -1:], dim=-1)
        toks.append(tok)
    assert torch.equal(restored, torch.cat(toks, dim=1))
    assert not torch.equal(restored, seqs)


def _spec(a):
    return tuple(a.shape), _jax_dtype(a)


def test_shapes_against_reference():
    """Every arch x shape: the cache length and window rules, and the
    train, prefill and decode input specs' shapes and dtypes."""
    assert SHT.LONG_WINDOW == SHJ.LONG_WINDOW
    assert {k: dataclasses.astuple(v) for k, v in SHT.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in SHJ.SHAPES.items()}
    for arch in RT.ARCH_IDS:
        ct, cj = RT.get_arch(arch), RJ.get_arch(arch)
        for name in SHT.SHAPES:
            st, sj = SHT.SHAPES[name], SHJ.SHAPES[name]
            what = (arch, name)
            assert st.is_decode == sj.is_decode
            assert SHT.decode_cache_len(ct, st) == \
                SHJ.decode_cache_len(cj, sj), what
            assert SHT.decode_window(ct, st) == SHJ.decode_window(cj, sj)
            clients = min(16, st.global_batch)
            for t, j in ((SHT.train_input_specs(ct, st, clients),
                          SHJ.train_input_specs(cj, sj, clients)),
                         (SHT.prefill_input_specs(ct, st),
                          SHJ.prefill_input_specs(cj, sj))):
                assert {k: (tuple(v.shape), _torch_dtype(v))
                        for k, v in t.items()} == \
                    {k: _spec(v) for k, v in j.items()}, what
            if st.global_batch < 16:
                with pytest.raises(ValueError, match="global batch"):
                    SHT.train_input_specs(ct, st, 16)
            dt = SHT.decode_input_specs(ct, st, quantized=name == "long_500k")
            dj = SHJ.decode_input_specs(cj, sj, quantized=name == "long_500k")
            assert all(v.device.type == "meta" for v in dt["cache"].values())
            assert {k: (tuple(v.shape), _torch_dtype(v))
                    for k, v in dt["cache"].items()} == {
                ".".join(str(k.key) for k in path): _spec(a) for path, a in
                jax.tree_util.tree_leaves_with_path(dj["cache"])}, what
            for k in ("token", "pos"):
                assert (tuple(dt[k].shape), _torch_dtype(dt[k])) == \
                    _spec(dj[k])


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def test_optimizers_against_reference():
    """``sgd`` (momentum 0 and 0.9) and ``adamw`` (with weight decay) for
    three steps against the reference op by op: the applied params (an
    f32 and a bf16 leaf), the moments and the step count bit for bit, and
    the updates bit for bit wherever the bias corrections ``b ** t``
    agree.  XLA's CPU ``pow`` is not correctly rounded (0.999 ** 3 is 1
    ULP above the rounded value that ``torch.pow`` gives, and the
    distance grows with t), and ``1 - 0.999 ** t`` magnifies that ULP
    about 330 times, so where they differ by one ULP the updates agree
    to rtol 3e-5."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    for (ij, uj), (it, ut), betas in (
            (sgd_jax(0.1), sgd(0.1), ()),
            (sgd_jax(0.1, 0.9), sgd(0.1, 0.9), ()),
            (adamw_jax(1e-3, weight_decay=0.01),
             adamw(1e-3, weight_decay=0.01), (0.9, 0.999))):
        with jax.disable_jit():
            pj = {"a": jnp.asarray(p0["a"]),
                  "b": jnp.asarray(p0["b"]).astype(jnp.bfloat16)}
            pt = {"a": torch.from_numpy(p0["a"]),
                  "b": torch.from_numpy(p0["b"]).to(torch.bfloat16)}
            sj, st = ij(pj), it(pt)
            for step, g in enumerate(grads, 1):
                updj, sj = uj({k: jnp.asarray(v) for k, v in g.items()}, sj,
                              pj)
                updt, st = ut({k: torch.from_numpy(v) for k, v in g.items()},
                              st, pt)
                tj = jnp.int32(step)
                ulps = [_ulps(b ** tj, torch.pow(b, torch.tensor(
                    step, dtype=torch.int32))) for b in betas]
                assert max(ulps, default=0) <= 1, (step, ulps)
                for k in p0:
                    if max(ulps, default=0) == 0:
                        np.testing.assert_array_equal(_np(updt[k]),
                                                      np.asarray(updj[k]))
                    else:
                        np.testing.assert_allclose(_np(updt[k]),
                                                   np.asarray(updj[k]),
                                                   rtol=3e-5)
                pj, pt = apply_updates_jax(pj, updj), apply_updates(pt, updt)
                assert pt["b"].dtype == torch.bfloat16
                if max(ulps, default=0) == 0:
                    for k in p0:
                        np.testing.assert_array_equal(
                            _np(pt[k].float()),
                            np.asarray(pj[k].astype(jnp.float32)))
                for key, v in sj.items():
                    if isinstance(v, dict):
                        for k in v:
                            np.testing.assert_array_equal(_np(st[key][k]),
                                                          np.asarray(v[k]))
                    else:
                        assert st[key].dtype == torch.int32
                        assert int(st[key]) == int(v) == step


def test_cache_conversion_round_trip():
    """A reference-structured cache of every leaf kind (bf16 KV, int8
    codes, f32 scales and states, int32 slot positions) crosses to the
    port's layout, equal to the port's own ``init_cache`` in names, shapes
    and dtypes, and back bit for bit."""
    for family, quantized in (("hybrid", True), ("encdec", False)):
        ct = port_cfg(FAMILIES[family], dtype=torch.bfloat16)
        cj = dataclasses.replace(FAMILIES[family], dtype=jnp.bfloat16)
        enc_len = 8 if family == "encdec" else 0
        ref = jax.eval_shape(lambda: MJ.init_cache(
            cj, B, S, enc_len, quantized=quantized))
        rng = np.random.default_rng(5)
        tree = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 50)
                            .astype(a.dtype), ref)
        port = cache_from_jax(tree)
        zero = MT.init_cache(ct, B, S, enc_len, quantized=quantized)
        assert {k: (v.shape, v.dtype) for k, v in port.items()} == \
            {k: (v.shape, v.dtype) for k, v in zero.items()}
        back = cache_to_jax(port)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree.leaves(back)):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
