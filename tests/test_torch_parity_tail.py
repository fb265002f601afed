"""The port's parity-decomposed tail (``fused_tail``) against the JAX
package's, on the CPU.

The same inputs (numpy, from a seed) go through JAX ``ops/parity_tail``
and the port's ``ops/parity_tail`` (its plain version: the CPU path), and
the same weights (``load_jax_variables``) through both train steps.  On the
card the tail is the kernels T1/T2 (``kernels/parity_tail.py``); their
decomposition into blocks is walked here by the module's emulations against
the plain version.  Tolerances:

- float64: the formulas, 1e-12 relative (both sides sum in other orders);
- float32: 2e-6 relative on the loss (the JAX package's own bound for its
  fused against its unfused tail, tests/test_parity_tail.py); confusion
  matrices exact (the parity values are the same lerps, rounded alike);
- bfloat16: the loss to 1e-2 relative (the planes, the softmax and the
  loss round at bfloat16's 2⁻⁸ where JAX rounds; XLA on the CPU and
  PyTorch evaluate exp and log differently); the matrix to 1 % of the
  pixels (a bfloat16 tie broken by one rounding flips a pixel).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.ops import parity_tail as jax_tail
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu.train import loss as jax_loss
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as kernel
from deeplabv3plus_keras_tpu_torch.models.decoder import softmax
from deeplabv3plus_keras_tpu_torch.ops import parity_tail
from deeplabv3plus_keras_tpu_torch.ops.resize import tf_resize_images, tf_resize_images_matmul
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.train import loss, metrics
from deeplabv3plus_keras_tpu_torch.train.loss import SS_NW, SS_PW
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

from torch_helpers import conf_dict, jax_model_and_traced_variables, port_model

torch.set_num_threads(1)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _nhwc_resize2(x: torch.Tensor) -> torch.Tensor:
    return tf_resize_images(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 8, 21), (1, 5, 9, 4), (3, 16, 12, 7)])
def test_parities_match_strided_resize(shape):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    up = _nhwc_resize2(x)
    planes = parity_tail.upsample2_parities(x)
    for ph in (0, 1):
        for pw in (0, 1):
            torch.testing.assert_close(planes[ph][pw], up[:, ph::2, pw::2], rtol=0, atol=5e-7)


def _inputs(seed, dense, with_valid, np_dtype, B=3, h=16, w=16, C=21):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, h, w, C)) * 2).astype(np_dtype)
    ids = rng.integers(0, C, (B, 2 * h, 2 * w))
    label = np.eye(C, dtype=np_dtype)[ids] if dense else ids
    valid = np.asarray([1, 1, 0][:B], np.int32) if with_valid else None
    return logits, label, valid


def _port_two_step(logits, label, valid):
    """The unfused tail: the decoder's float32 upsample form, softmax, loss
    and confusion matrix of the full-resolution probabilities."""
    C = logits.shape[-1]
    up = tf_resize_images_matmul(logits.permute(0, 3, 1, 2), 2, 2)
    probs = softmax(up, dim=1).permute(0, 2, 3, 1)
    if label.dim() == 4:
        return (loss.class_balanced_loss(label, probs, SS_PW[:C], SS_NW[:C], valid=valid),
                metrics.confusion_matrix_update(label, probs, C, valid))
    return (loss.class_balanced_loss_sparse(label, probs, SS_PW[:C], SS_NW[:C], valid=valid),
            metrics.confusion_matrix_update_sparse(label, probs, C, valid))


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("with_valid", [False, True])
def test_tail_loss_cm_matches_jax_and_the_two_step_tail(x64, np_dtype, dense, with_valid):
    logits, label, valid = _inputs(2, dense, with_valid, np_dtype)
    C = logits.shape[-1]
    jl, jcm = jax_tail.tail_loss_cm(jnp.asarray(logits), jnp.asarray(label), SS_PW[:C], SS_NW[:C],
                                    C, None if valid is None else jnp.asarray(valid))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in
         (("logits", logits), ("label", label), ("valid", valid))}
    pl, pcm = parity_tail.tail_loss_cm(t["logits"], t["label"], SS_PW[:C], SS_NW[:C], C, t["valid"])
    tl, tcm = _port_two_step(t["logits"], t["label"], t["valid"])
    bound = 1e-12 if np_dtype == np.float64 else 2e-6
    assert pl.dtype == torch.from_numpy(logits).dtype
    assert abs(float(pl) - float(jl)) <= bound * abs(float(jl)), (float(pl), float(jl))
    assert abs(float(pl) - float(tl)) <= bound * abs(float(tl)), (float(pl), float(tl))
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(pcm.numpy(), tcm.numpy())
    if with_valid:
        assert int(pcm.sum()) == 2 * 4 * 16 * 16  # the padded sample counts nothing


@pytest.mark.parametrize("dense", [True, False])
def test_bfloat16_tail_matches_jax_bfloat16(dense):
    logits, label, valid = _inputs(4, dense, True, np.float32)
    C = logits.shape[-1]
    jl, jcm = jax_tail.tail_loss_cm(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(label),
                                    SS_PW[:C], SS_NW[:C], C, jnp.asarray(valid))
    pl, pcm = parity_tail.tail_loss_cm(torch.from_numpy(logits).bfloat16(), torch.from_numpy(label),
                                       SS_PW[:C], SS_NW[:C], C, torch.from_numpy(valid))
    assert pl.dtype == torch.float32
    assert abs(float(pl) - float(jl)) <= 1e-2 * abs(float(jl)), (float(pl), float(jl))
    np.testing.assert_array_equal(pcm.sum(1).numpy(), np.asarray(jcm).sum(1))
    assert np.abs(pcm.numpy() - np.asarray(jcm)).sum() <= 2 * 0.01 * int(pcm.sum())


def test_masked_pixel_mean_total_pixels_matches_jax():
    rng = np.random.default_rng(5)
    per = rng.uniform(0, 2, (3, 4, 5)).astype(np.float32)
    v = np.asarray([1, 0, 1], np.int32)
    for valid in (None, v):
        ref = jax_loss.masked_pixel_mean(jnp.asarray(per), None if valid is None else jnp.asarray(valid),
                                         total_pixels_per_sample=80)
        got = loss.masked_pixel_mean(torch.from_numpy(per), None if valid is None else torch.from_numpy(valid),
                                     total_pixels_per_sample=80)
        assert abs(float(got) - float(ref)) <= 4e-7 * abs(float(ref))  # float32, other sum order
    # composes with the global count of a process group
    got = loss.masked_pixel_mean(torch.from_numpy(per), torch.from_numpy(v), torch.tensor(4.0),
                                 total_pixels_per_sample=80)
    assert float(got) == pytest.approx(float((per.sum((1, 2)) * v).sum()) / (4 * 80), rel=1e-6)


# ---------------------------------------------------------------------------
# the kernels' decomposition, emulated


# (B, H, W, C), (tr, tw[, walk]): the flagship's plan at a small map, tiles
# cut on both axes and ragged at the edges, C even (the odd class stride),
# one row, one site a block, a ragged walk; then the default plan at each
# instantiation's class bound and past it (C = 8, 16, 21 in the C ≤ 24
# one, 32, and 33 and 150 in the multi-pass one, whose matrix is counted in
# device memory at 150)
PLAN_CASES = [
    ((2, 8, 8, 21), None),
    ((2, 5, 9, 4), (2, 4)),
    ((3, 7, 6, 8), (1, 2)),
    ((1, 1, 3, 5), (1, 1)),
    ((2, 6, 10, 21), (4, 4)),
    ((2, 7, 6, 8), (1, 2, 3)),
    ((2, 9, 5, 8), None),
    ((2, 5, 7, 16), None),
    ((1, 10, 18, 21), None),
    ((2, 6, 9, 32), None),
    ((2, 5, 6, 33), None),
    ((1, 3, 5, 150), None),
]


@pytest.mark.parametrize("shape,tile", PLAN_CASES)
@pytest.mark.parametrize("dense", [True, False])
def test_kernel_decomposition_matches_plain(shape, tile, dense):
    """T1's blocks (their tiles' windows, pixels, per-thread sums across the
    walk, block sums, matrix) and T2's (pixel gradients of the tile and its
    halo, column then row pass) walked in float64, in the formulas of the
    plan's instantiation, against the plain version and its autograd:
    1e-12."""
    B, H, W, C = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2
    ids = torch.randint(0, C, (B, 2 * H, 2 * W), generator=g)
    lab = torch.nn.functional.one_hot(ids, C).to(torch.float32) if dense else ids
    pw, nw = np.linspace(0.3, 0.99, C), np.linspace(0.7, 0.01, C)
    valid = torch.tensor([1, 0, 1][:B])
    plan = kernel._parity_tail_make(B, H, W, C, *tile) if tile else kernel._parity_tail_plan(B, H, W, C)
    s0, cm0 = kernel.parity_tail_forward_plain(x, lab, pw, nw, valid)
    s1, cm1 = kernel.parity_tail_forward_emulation(x, lab, pw, nw, valid, plan=plan)
    torch.testing.assert_close(s1, s0, rtol=1e-12, atol=0)
    assert torch.equal(cm1, cm0)
    scale = torch.rand(B, generator=g, dtype=torch.float64)
    scale[-1] = 0.0 if B > 1 else scale[-1]
    d0 = kernel.parity_tail_backward_plain(x, lab, pw, nw, scale)
    d1 = kernel.parity_tail_backward_emulation(x, lab, pw, nw, scale, plan=plan)
    torch.testing.assert_close(d1, d0, rtol=0, atol=1e-12 * float(d0.abs().max()))
    if B > 1:
        assert not d0[-1].any()  # a scale of 0 (a padded sample): no gradient


def test_soft_labels_take_both_terms_in_either_instantiation():
    """A one-hot label that is not 0 or 1 (a soft label) takes both loss
    terms in the one-pass formulas as in the multi-pass ones: the emulation
    of each against the plain version in float64, 1e-12."""
    B, H, W, C = 1, 3, 4, 6
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, H, W, C, generator=g, dtype=torch.float64)
    lab = torch.softmax(torch.randn(B, 2 * H, 2 * W, C, generator=g, dtype=torch.float64), -1)
    pw, nw = np.linspace(0.3, 0.99, C), np.linspace(0.7, 0.01, C)
    scale = torch.tensor([0.7], dtype=torch.float64)
    s0, _ = kernel.parity_tail_forward_plain(x, lab, pw, nw)
    d0 = kernel.parity_tail_backward_plain(x, lab, pw, nw, scale)
    one_pass = kernel._parity_tail_plan(B, H, W, C)
    multi = dataclasses.replace(one_pass, cmax=0)
    for plan in (one_pass, multi):
        s1, _ = kernel.parity_tail_forward_emulation(x, lab, pw, nw, plan=plan)
        d1 = kernel.parity_tail_backward_emulation(x, lab, pw, nw, scale, plan=plan)
        torch.testing.assert_close(s1, s0, rtol=1e-12, atol=0)
        torch.testing.assert_close(d1, d0, rtol=0, atol=1e-12 * float(d0.abs().max()))


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("dense", [True, False])
def test_row_window_blocks_sum_to_the_whole_tail(S, dense):
    """The row window of T1/T2 (``mesh_space``): h = 7 logits rows split
    over S ranks by ``mesh.rows_of``, each block its sites with a context
    row above and below (edge-clamped at the image's edges) and its
    sites' label rows.  Summed over the blocks, the windowed plain
    version's per-sample sums and matrices equal the whole map's
    ``tail_loss_cm`` and its sums, and its dlogits, scattered back
    through the clamp, the gradient of that loss; the emulations (the
    default plan, 2 × 4 tiles, and 1 × 2 tiles walked 3 at a time) equal
    the windowed plain version.  float64, 1e-12."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    B, h, w, C = 2, 7, 5, 8
    g = torch.Generator().manual_seed(S + 10 * dense)
    x = torch.randn(B, h, w, C, generator=g, dtype=torch.float64) * 2
    ids = torch.randint(0, C, (B, 2 * h, 2 * w), generator=g)
    lab = torch.nn.functional.one_hot(ids, C).to(torch.float64) if dense else ids
    pw, nw = np.linspace(0.3, 0.99, C), np.linspace(0.7, 0.01, C)
    valid = torch.tensor([1, 0])
    xr = x.clone().requires_grad_()
    loss_whole, cm_whole = parity_tail.tail_loss_cm(xr, lab, pw, nw, C, valid)
    (gx,) = torch.autograd.grad(loss_whole, xr)
    sums_whole, _ = kernel.parity_tail_forward_plain(x, lab, pw, nw, valid)
    # what autograd hands the per-sample sums of the loss
    scale = valid.to(torch.float64) / (valid.sum() * 4 * h * w)
    for tile in (None, (2, 4), (1, 2, 3)):
        sums, cm, dx = 0, 0, torch.zeros_like(x)
        for q in range(S):
            a, b = mesh.rows_of(h, S, q)
            if a == b:
                continue
            rows = torch.arange(a - 1, b + 1).clamp(0, h - 1)
            blk, lb = x[:, rows], lab[:, 2 * a:2 * b]
            plan = kernel._parity_tail_make(B, b - a + 2, w, C, *tile, window=True) if tile else None
            s0, c0 = kernel.parity_tail_forward_plain(blk, lb, pw, nw, valid, window=True)
            s1, c1 = kernel.parity_tail_forward_emulation(blk, lb, pw, nw, valid, plan=plan,
                                                          window=True)
            torch.testing.assert_close(s1, s0, rtol=1e-12, atol=0)
            assert torch.equal(c1, c0)
            d0 = kernel.parity_tail_backward_plain(blk, lb, pw, nw, scale, window=True)
            d1 = kernel.parity_tail_backward_emulation(blk, lb, pw, nw, scale, plan=plan,
                                                       window=True)
            torch.testing.assert_close(d1, d0, rtol=0, atol=1e-12 * float(d0.abs().max()))
            sums, cm = sums + s0, cm + c0
            dx.index_add_(1, rows, d0)
        torch.testing.assert_close(sums, sums_whole, rtol=1e-12, atol=0)
        mean = float(loss.masked_pixel_mean(sums, valid, total_pixels_per_sample=4 * h * w))
        assert abs(mean - loss_whole.item()) <= 1e-12 * abs(loss_whole.item())
        assert torch.equal(cm, cm_whole)
        torch.testing.assert_close(dx, gx, rtol=0, atol=1e-12 * float(gx.abs().max()))


def test_row_window_plan_tiles_own_sites_and_every_row():
    """Under a row window T1's tiles cover the site rows 1 .. H − 2 once
    (from row 1), T2's every row (it writes the context rows' dlogits);
    the whole map's plan is unchanged; a window of fewer than 3 rows holds
    no site and raises."""
    for B, H, W, C in ((1, 5, 9, 4), (2, 35, 17, 21), (1, 3, 1, 1), (2, 18, 40, 33)):
        p = kernel._parity_tail_plan(B, H, W, C, window=True)
        assert (p.s0, p.s1) == (1, H - 1)
        for kind, first, last in (("fwd", 1, H - 1), ("bwd", 0, H)):
            sites = [(b, i, j) for b, tiles in p.blocks(kind) for i0, j0 in tiles
                     for i in range(i0, min(i0 + p.tr, last)) for j in range(j0, min(j0 + p.tw, W))]
            assert sorted(sites) == sorted(set(sites)) and len(sites) == B * (last - first) * W
            assert min(i for _, i, _ in sites) == first
        assert len(list(p.blocks())) == p.grid[0] * p.grid[1] * B
        assert len(list(p.blocks("bwd"))) == p.bwd_grid[0] * p.bwd_grid[1] * B
        whole = kernel._parity_tail_plan(B, H, W, C)
        assert (whole.s0, whole.s1, whole.grid, whole.rows) == (0, H, whole.bwd_grid, whole.bwd_rows)
    with pytest.raises(ValueError, match="no site"):
        kernel._parity_tail_plan(1, 2, 8, 21, window=True)


def test_kernel_plan_fits_the_card_and_covers_the_map():
    """The flagship's tail takes the C ≤ 24 instantiation: tiles of 4 × 16
    sites, a block walking 4 of them (16 row-tile groups), T1 256 threads,
    T2 352 (its 10 × 34-pixel region in one round), the class stride 25;
    C picks the instantiation alone; ADE20K's 150 classes take the
    multi-pass kernels at smaller tiles, one a block, with the matrix in
    device memory; every site is covered once."""
    plan = kernel._parity_tail_plan(16, 256, 256, 21)
    assert (plan.tr, plan.tw, plan.cp, plan.cmax, plan.walk, plan.hist) == (4, 16, 25, 24, 4, True)
    assert (plan.fwd_threads, plan.bwd_threads) == (256, 352)
    assert plan.grid == (16, 16, 16) and plan.rows == 64
    assert max(plan.fwd_smem, plan.bwd_smem) <= 96 * 1024
    assert plan.fwd_smem_int < plan.fwd_smem and plan.bwd_smem_int < plan.bwd_smem
    # float32 one-hot labels at an odd C: read in place, double-buffered; two blocks an SM
    assert 2 * (max(plan.fwd_smem_direct, plan.bwd_smem_direct) + 1024) <= 228 * 1024
    assert [kernel._parity_tail_plan(2, 16, 16, C).cmax for C in (1, 8, 9, 16, 17, 24, 25, 32, 33)] == [
        8, 8, 16, 16, 24, 24, 32, 32, 0]
    wide = kernel._parity_tail_plan(2, 64, 64, 150)  # ADE20K's classes: smaller tiles
    assert wide.cmax == 0 and wide.walk == 1 and wide.tw < 16 and not wide.hist
    assert max(wide.fwd_smem, wide.bwd_smem) <= 96 * 1024
    for B, H, W, C in ((1, 5, 9, 4), (2, 33, 17, 21), (1, 1, 1, 1), (2, 13, 40, 33)):
        p = kernel._parity_tail_plan(B, H, W, C)
        sites = [(b, i, j) for b, tiles in p.blocks() for i0, j0 in tiles
                 for i in range(i0, min(i0 + p.tr, H)) for j in range(j0, min(j0 + p.tw, W))]
        assert sorted(sites) == sorted(set(sites)) and len(sites) == B * H * W
        assert len(list(p.blocks())) == p.grid[0] * p.grid[1] * B
        assert p.fwd_threads == -(-4 * p.tr * p.tw // 32) * 32 <= 256  # a thread a pixel
        assert p.bwd_threads == -(-(2 * p.tr + 2) * (2 * p.tw + 2) // 32) * 32 <= 352
    with pytest.raises(ValueError, match="C=3000"):
        kernel._parity_tail_plan(1, 8, 8, 3000)


def test_cpu_takes_the_plain_version_and_other_devices_raise():
    kernels.reset_launch_counts()
    x = torch.randn(1, 4, 4, 3, requires_grad=True)
    lab = torch.randint(0, 3, (1, 8, 8))
    sums, cm = kernel.parity_tail_forward(x, lab, np.ones(3), np.zeros(3))
    ref, rcm = kernel.parity_tail_forward_plain(x, lab, np.ones(3), np.zeros(3))
    assert torch.equal(sums, ref) and torch.equal(cm, rcm)
    assert set(kernels.launch_counts().values()) == {0}
    meta = torch.zeros(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="meta"):
        parity_tail.tail_loss_cm(meta, torch.zeros(1, 8, 8, dtype=torch.long, device="meta"),
                                 np.ones(3), np.zeros(3), 3)
    with pytest.raises(ValueError, match="meta"):
        kernel.parity_tail_forward(meta, torch.zeros(1, 8, 8, dtype=torch.long, device="meta"),
                                   np.ones(3), np.zeros(3))


# ---------------------------------------------------------------------------
# the steps


def _fused_conf(np_dtype, size=32, **extra):
    conf = conf_dict(size, fused_tail=True, **extra)
    conf["hps"].update(dtype=np.dtype(np_dtype).name, lr=1e-4, decay=0.0)
    conf["nn_arch"]["dropout_rate"] = 0.0  # the one stochastic layer; off on both sides
    return conf


def _batch(np_dtype, sparse=False, valid=(1, 1), seed=11, size=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (len(valid), size, size, 3)).astype(np_dtype)
    ids = rng.integers(0, 21, (len(valid), size, size))
    return {"image": x, "label": ids if sparse else np.eye(21, dtype=np_dtype)[ids],
            "valid": np.asarray(valid, np.int32)}


def _one_step_both(np_dtype, conf, batch):
    """One fused train step on each side from the same weights: (jax loss,
    jax cm, jax params, jax grads of the step's loss, port output, port
    model)."""
    jm, v = jax_model_and_traced_variables(conf, seed=7)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np_dtype), v)
    pm = port_model(conf, v).to(torch.float64 if np_dtype == np.float64 else torch.float32)
    jconf, pconf = JaxConfig.from_dict(conf), Config.from_dict(conf)
    jstate, tx = jax_step.create_train_state(jconf, jax.tree_util.tree_map(jnp.asarray, v))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jstate2, jout = jax.jit(jax_step.build_train_step(jm, tx, jconf))(jstate, jb, jax.random.PRNGKey(3))
    pout = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)(
        {k: torch.from_numpy(a) for k, a in batch.items()})
    return jout, jstate, jstate2, pout, pm, jm


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_fused_train_step_matches_jax_fp32():
    """One float32 step: the loss to 2e-6 relative and the confusion matrix
    exactly (the JAX test's bounds for its fused against its unfused step),
    the parameters after the update to 3·lr (Keras Adam's first update is
    ±lr·sign(g): a gradient rounding across 0 moves a parameter by 2·lr)."""
    conf = _fused_conf(np.float32)
    jout, _, jstate2, pout, pm, _ = _one_step_both(np.float32, conf, _batch(np.float32))
    assert abs(float(pout["loss"]) - float(jout["loss"])) <= 2e-6 * abs(float(jout["loss"]))
    np.testing.assert_array_equal(pout["cm"].numpy(), np.asarray(jout["cm"]))
    got = _flat(export_jax_variables(pm)["params"])
    for path, a in _flat(jstate2.params).items():
        np.testing.assert_allclose(got[path], np.asarray(a), rtol=0, atol=3 * conf["hps"]["lr"],
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_train_step_gradients_match_jax_fp64(x64):
    """float64, integer labels, a padded sample: the port's fused step
    (its loss, matrix and the gradients it leaves in ``.grad``) against
    JAX's fused loss at the same weights (the JAX step's ``grads_one``,
    ``step.py:163-182``, under ``jax.value_and_grad``): the loss to 1e-12,
    the matrix exactly, each gradient to 1e-9 of its tensor's largest entry
    (or of a thousandth of the largest gradient, for a tensor whose
    gradient is rounding noise about 0)."""
    conf = _fused_conf(np.float64)
    batch = _batch(np.float64, sparse=True, valid=(1, 0))
    jm, v = jax_model_and_traced_variables(conf, seed=7)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    pm = port_model(conf, v).to(torch.float64)
    pconf = Config.from_dict(conf)
    pout = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)(
        {k: torch.from_numpy(a) for k, a in batch.items()})
    wd = JaxConfig.from_dict(conf).hps.weight_decay
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(p):
        (logits, _), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jb["image"],
                                  train=True, mutable=["batch_stats"], return_presample=True)
        lo, cm = jax_tail.tail_loss_cm(logits, jb["label"], SS_PW, SS_NW, 21, jb["valid"])
        return lo + jax_loss.l2_penalty(p, wd), cm

    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    (jl, jcm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert abs(float(pout["loss"]) - float(jl)) <= 1e-12 * abs(float(jl))
    np.testing.assert_array_equal(pout["cm"].numpy(), np.asarray(jcm))
    with torch.no_grad():  # the gradients into the weights, to name them as flax does
        for p in pm.parameters():
            p.copy_(p.grad)
    got, jg = _flat(export_jax_variables(pm)["params"]), _flat(jg)
    assert got.keys() == jg.keys()
    top = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for path, g in jg.items():
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        assert float(np.abs(got[path] - g).max()) <= 1e-9 * scale, jax.tree_util.keystr(path)


def test_fused_grad_accum_matches_unfused():
    """grad_accum 2 with the key over a batch whose second sample is
    padding (a microbatch of padding alone: its loss 0), integer labels:
    one float32 step against the same step without the key, from the same
    weights: the loss to 2e-6 relative, the matrix exactly, the gradients
    to 1e-4 in relative 2-norm (float32 reassociation in the tail, carried
    back through the network; measured 8e-7)."""
    conf = _fused_conf(np.float32, grad_accum=2)
    _, v = jax_model_and_traced_variables(conf, seed=7)
    batch = {k: torch.from_numpy(a) for k, a in
             _batch(np.float32, sparse=True, valid=(1, 0)).items()}
    out = {}
    for fused in (True, False):
        pm = port_model(conf, v)
        pconf = Config.from_dict({**conf, "fused_tail": fused})
        res = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)(batch)
        out[fused] = res, [p.grad.clone() for p in pm.parameters()]
    (a, ga), (b, gb) = out[True], out[False]
    assert abs(float(a["loss"]) - float(b["loss"])) <= 2e-6 * abs(float(b["loss"]))
    assert torch.equal(a["cm"], b["cm"]) and int(a["cm"].sum()) == 32 * 32
    diff = sum(float((x - y).double().square().sum()) for x, y in zip(ga, gb))
    norm = sum(float(y.double().square().sum()) for y in gb)
    assert (diff / norm) ** 0.5 <= 1e-4, (diff / norm) ** 0.5


def test_fused_eval_step_matches_unfused():
    """Eval mode after a ``bn_momentum=0`` step (the running statistics are
    then one batch's, so the logits are decisive, as JAX
    tests/test_parity_tail.py:118 sets it up): the fused eval step's loss
    to 2e-6 of the unfused one's, the confusion matrix exact; a step with
    probabilities or test-time augmentation keeps the unfused tail."""
    conf = _fused_conf(np.float32)
    conf["hps"]["bn_momentum"] = 0.0
    _, v = jax_model_and_traced_variables(conf, seed=7)
    pm = port_model(conf, v)
    pconf = Config.from_dict(conf)
    batch = {k: torch.from_numpy(a) for k, a in _batch(np.float32, valid=(1, 0)).items()}
    port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)(batch)
    fused = port_step.build_eval_step(pm, pconf, with_probs=False)(batch)
    plain_conf = Config.from_dict({**conf, "fused_tail": False})
    plain = port_step.build_eval_step(pm, plain_conf, with_probs=False)(batch)
    assert abs(float(fused["loss"]) - float(plain["loss"])) <= 2e-6 * abs(float(plain["loss"]))
    assert torch.equal(fused["cm"], plain["cm"]) and int(fused["cm"].sum()) == 32 * 32
    with_probs = port_step.build_eval_step(pm, pconf, with_probs=True)(batch)
    assert torch.equal(with_probs["cm"], plain["cm"]) and "probs" in with_probs
    tta = port_step.build_eval_step(pm, pconf, with_probs=False, tta_flip=True)(batch)
    tta_plain = port_step.build_eval_step(pm, plain_conf, with_probs=False, tta_flip=True)(batch)
    assert torch.equal(tta["loss"], tta_plain["loss"]) and torch.equal(tta["cm"], tta_plain["cm"])


def test_key_is_ignored_without_boundary_refinement():
    """Without refinement the last upsample is ×os, not ×2: the key is
    ignored (JAX ``_use_fused_tail``), and the step equals the plain one
    bit for bit."""
    assert port_step._use_fused_tail(Config.from_dict(conf_dict(32, fused_tail=True)))
    assert not port_step._use_fused_tail(Config.from_dict(conf_dict(32, refine=False, fused_tail=True)))
    assert not port_step._use_fused_tail(Config.from_dict(conf_dict(32)))
    out = []
    for extra in ({"fused_tail": True}, {}):
        seg = SemanticSegmentation(conf_dict(32, refine=False, **extra), device="cpu")
        b = _batch(np.float32)
        out.append((seg.train_step(b), seg.eval_step(b)))
    for a, b in zip(*out):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["cm"], b["cm"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_step_matches_the_parity_tail(dtype):
    """In a 16-bit dtype the plain tail of the train step reads float32
    probabilities, as the parity tail reads float32 logits (ROADMAP C5).
    The classifier's weights are scaled 60× so that most pixels are
    confidently wrong; one step with the key and one without, from the
    same weights, agree on the loss to 1e-5 relative (measured 7e-8 in
    bfloat16, 3e-7 in float16) and on the gradients to 0.1 in relative
    2-norm (measured 0.020 and 0.0022: the 16-bit backward of dlogits that
    differ by float32 reassociation, one 16-bit step where they straddle a
    rounding).  With the probabilities rounded to 16 bits, as
    ``jax.nn.softmax`` returns them, a confidently wrong class's
    probability is 1.0 and its log(1 − p + ε) term's gradient 1e7 times
    too large: the losses were 1.1e-3 and 1.6e-3 apart, the gradients 69×
    and 13× the parity tail's norm."""
    conf = _fused_conf(np.float32)
    conf["hps"]["dtype"] = dtype
    _, v = jax_model_and_traced_variables(conf, seed=7)
    v["params"]["decoder"]["classifier_l2"]["kernel"] *= 60.0
    batch = {k: torch.from_numpy(a) for k, a in _batch(np.float32, sparse=True).items()}
    out = {}
    for fused in (True, False):
        pm = port_model(conf, v)
        pconf = Config.from_dict({**conf, "fused_tail": fused})
        res = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)(batch)
        out[fused] = res, [p.grad.clone() for p in pm.parameters()]
    (a, ga), (b, gb) = out[True], out[False]
    assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-5 * abs(float(a["loss"]))
    diff = sum(float((x - y).double().square().sum()) for x, y in zip(ga, gb))
    norm = sum(float(x.double().square().sum()) for x in ga)
    assert (diff / norm) ** 0.5 <= 0.1, (diff / norm) ** 0.5
