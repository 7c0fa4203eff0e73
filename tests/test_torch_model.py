"""(c) The port's dense model against the reference: parameter layout, and
loss and gradients of ``paper_lm`` and the reduced ``llama3_2_1b`` from the
reference's own init (``params_from_jax``) on a numpy batch.

Tolerances: loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6.  The two
frameworks sum f32 reductions (matmuls, norms, softmax) in different
orders, so agreement is to float rounding, not to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_jax
from repro.configs.registry import get_smoke as get_smoke_jax
from repro.models.model import Model as ModelJax
from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model
from test_torch_jaxkeys import one_torch_thread, quick_jit  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = [("paper_lm", get_arch_jax, get_arch),
         ("llama3_2_1b", get_smoke_jax, get_smoke)]


def _batch(vocab, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
            "mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


@pytest.mark.parametrize("name,jax_cfg,port_cfg", ARCHS,
                         ids=[a[0] for a in ARCHS])
def test_loss_and_grads_match_reference(name, jax_cfg, port_cfg):
    mj = ModelJax(jax_cfg(name))
    mt = Model(port_cfg(name))
    pj = mj.init(jax.random.PRNGKey(3))
    b = _batch(mt.cfg.vocab_size)
    # optimization level 0 compiles in about half the time; the default
    # jit contracts FMAs as well, and the tolerances cover either
    loss_j, g_j = quick_jit(jax.value_and_grad(
        lambda p: mj.loss(p, {k: jnp.asarray(v) for k, v in b.items()},
                          chunk=8)[0]))(pj)
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    leaves = {k: v.requires_grad_(True) for k, v in pt.items()}
    loss_t = mt.loss(leaves, _torch_batch(b), chunk=8)[0]
    g_t = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    flat_j = jax.tree.leaves(g_j)
    assert len(flat_j) == len(g_t)
    for (k, gt), gj in zip(zip(leaves, g_t), flat_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{name} grad {k}")


def test_paper_lm_leaf_order_and_sizes():
    """The port's flat leaves are the reference's ``jax.tree.leaves`` in
    order: 12 stacked leaves, 361,088 params for paper_lm."""
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    paths = [".".join(str(getattr(k, "key", k)) for k in path) for path, _
             in jax.tree_util.tree_flatten_with_path(
                 mj.abstract_params())[0]]
    assert list(mt.defs) == paths
    assert list(mt.defs) == [
        "embed", "final_ln", "layers.b0.ffn.ln", "layers.b0.ffn.w_down",
        "layers.b0.ffn.w_gate", "layers.b0.ffn.w_up", "layers.b0.mixer.ln",
        "layers.b0.mixer.wk", "layers.b0.mixer.wo", "layers.b0.mixer.wq",
        "layers.b0.mixer.wv", "lm_head"]
    assert [d.shape for d in mt.defs.values()] == \
        [tuple(a.shape) for a in jax.tree.leaves(mj.abstract_params())]
    assert mt.param_count() == mj.param_count() == 361_088
    assert mt.defs["layers.b0.ffn.w_up"].shape == (2, 128, 256)


def test_llama_full_width_layout_matches_reference():
    """Full-width llama3_2_1b: 11 leaves (tied embeddings), the same
    shapes as the reference; the largest leaf is w_up at 268,435,456."""
    mj = ModelJax(get_arch_jax("llama3_2_1b"))
    mt = Model(get_arch("llama3_2_1b"))
    shapes = [tuple(a.shape) for a in jax.tree.leaves(mj.abstract_params())]
    assert [d.shape for d in mt.defs.values()] == shapes
    assert max(mt.param_sizes()) == 268_435_456 == \
        mt.param_sizes()[list(mt.defs).index("layers.b0.ffn.w_up")]
    assert mt.param_count() == mj.param_count()


def test_convert_roundtrips_bf16_bits():
    import ml_dtypes
    a = (np.random.default_rng(0).standard_normal((3, 5))
         .astype(ml_dtypes.bfloat16))
    tree = {"b": {"w": a}, "a": np.arange(4, dtype=np.float32)}
    pt = params_from_jax(tree)
    assert list(pt) == ["a", "b.w"] and pt["b.w"].dtype == torch.bfloat16
    back = params_to_jax(pt)
    np.testing.assert_array_equal(back["b"]["w"].view(np.uint16),
                                  a.view(np.uint16))
    np.testing.assert_array_equal(back["a"], tree["a"])
