"""The port's SAM modules (`multiply_tpu_torch/models/sam.py`) against the JAX
package's (`multiply_tpu/models/sam.py`) on the CPU.

Both sides take their weights from one random state dict in the official
`segment_anything` key layout (`_torch_sam.make_state_dict`, every leaf
random, `pos_embed` and the rel-pos tables included): the JAX side through its
`port_torch_checkpoint`, the port by a strict `load_state_dict`. `vit_test`
runs at a 128-pixel input (an 8x8 token grid, one padded 14x14 window);
`vit_b2` at the real 1024 input (64x64 grid padded to 70x70, a global block
over 4096 tokens). `Sam.decode` also runs from the JAX package's own
initialisation, carried across by `convert.sam_state_dict_from_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
import _torch_sam as oracle
import multiply_tpu.models.sam as jsam
from multiply_tpu_torch.convert import sam_state_dict_from_jax
from multiply_tpu_torch.models import sam as tsam

IMG = 128


def _ported(variant, img, tmp_path_factory, seed=0):
    """(JAX params, the port's Sam, the official state dict) at one size."""
    sd = oracle.make_state_dict(jsam.VIT_CONFIGS[variant], img, seed=seed)
    path = str(tmp_path_factory.mktemp("sam") / f"{variant}.pth")
    torch.save(sd, path)
    params = jsam.port_torch_checkpoint(path, variant)
    model = tsam.Sam(variant, img_size=img)
    model.load_state_dict(sd, strict=True)
    return params, model.eval(), sd


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "IMG_SIZE", IMG)
        return _ported("vit_test", IMG, tmp_path_factory)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("hw, w", [((10, 13), 7), ((64, 64), 14), ((8, 8), 14)])
def test_window_partition_round_trip_with_padding(hw, w):
    x = np.random.default_rng(0).standard_normal((*hw, 6)).astype(np.float32)
    ours, pad_hw = tsam.window_partition(torch.from_numpy(x)[None], w)
    theirs, their_pad = jsam.window_partition(jnp.asarray(x), w)
    assert pad_hw == tuple(their_pad)
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
    back = tsam.window_unpartition(ours, w, pad_hw, hw)[0]
    np.testing.assert_array_equal(_np(back), x)
    np.testing.assert_array_equal(np.asarray(jsam.window_unpartition(theirs, w, their_pad, hw)), x)


@pytest.mark.parametrize("src_len, q", [(127, 64), (63, 64), (27, 14), (19, 14), (15, 8)])
def test_get_rel_pos_both_branches(src_len, q):
    """Same length (a plain gather) and another length (linear resize first)."""
    rel = np.random.default_rng(1).standard_normal((src_len, 16)).astype(np.float32)
    ours = tsam.get_rel_pos(q, q, torch.from_numpy(rel))
    theirs = jsam.get_rel_pos(q, q, jnp.asarray(rel))
    assert ours.shape == (q, q, 16)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block, batch, size", [(0, 3, 14), (1, 1, 8)], ids=["windowed", "global"])
def test_vit_attention(tiny, block, batch, size):
    params, model, _ = tiny
    C = jsam.VIT_CONFIGS["vit_test"]["embed_dim"]
    x = np.random.default_rng(2).standard_normal((batch, size, size, C)).astype(np.float32)
    p = params["params"]["image_encoder"][f"block{block}"]["attn"]
    theirs = jsam.ViTAttention(C, 2, input_size=(size, size)).apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        ours = model.image_encoder.blocks[block].attn(torch.from_numpy(x))
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("block", [0, 1], ids=["windowed", "global"])
def test_vit_block(tiny, block):
    params, model, _ = tiny
    cfg = jsam.VIT_CONFIGS["vit_test"]
    grid = IMG // jsam.PATCH
    x = np.random.default_rng(3).standard_normal((1, grid, grid, cfg["embed_dim"])).astype(np.float32)
    window = 0 if block in cfg["global_attn"] else 14
    theirs = jsam.ViTBlock(cfg["embed_dim"], cfg["num_heads"], window_size=window, input_size=(grid, grid)).apply(
        {"params": params["params"]["image_encoder"][f"block{block}"]}, jnp.asarray(x))
    with torch.no_grad():
        ours = model.image_encoder.blocks[block](torch.from_numpy(x))
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=1e-4, rtol=1e-4)


def test_image_encoder_vit_test(tiny):
    params, model, _ = tiny
    x = np.random.default_rng(4).standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "IMG_SIZE", IMG)
        theirs = jsam.Sam(variant="vit_test").apply(params, jnp.asarray(x), method=jsam.Sam.encode_image)
    with torch.no_grad():
        ours = model.encode_image(torch.from_numpy(x))
    assert ours.shape == (1, IMG // 16, IMG // 16, 256)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=2e-4, rtol=2e-4)


def test_image_encoder_vit_b2_at_1024(tmp_path_factory):
    """vit_b's widths at the real input: patch embedding to 64x64, a windowed
    block padded to 70x70 (25 windows), a global block over 4096 tokens, the
    neck. One forward a side."""
    params, model, _ = _ported("vit_b2", jsam.IMG_SIZE, tmp_path_factory, seed=1)
    x = np.random.default_rng(5).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    theirs = np.asarray(jsam.Sam(variant="vit_b2").apply(params, jnp.asarray(x), method=jsam.Sam.encode_image))
    with torch.no_grad():
        ours = model.encode_image(torch.from_numpy(x))
    assert ours.shape == (1, 64, 64, 256)
    np.testing.assert_allclose(_np(ours), theirs, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_prompt_encoder(tiny, with_mask):
    params, model, _ = tiny
    grid = IMG // 16
    pts = np.array([[10.0, 20.0], [50.0, 90.0], [0.0, 0.0], [30.0, 40.0], [100.0, 7.0], [0.0, 0.0]], np.float32)
    lbl = np.array([1, 0, -1, 2, 3, -1], np.int32)
    mask = np.random.default_rng(6).standard_normal((grid * 4, grid * 4)).astype(np.float32) if with_mask else None

    def run(mdl, pts, lbl, m):
        sparse, dense = mdl.prompt_encoder(pts, lbl, m)
        return sparse, dense, mdl.prompt_encoder.dense_pe(grid)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "IMG_SIZE", IMG)
        theirs = jsam.Sam(variant="vit_test").apply(
            params, jnp.asarray(pts), jnp.asarray(lbl), None if mask is None else jnp.asarray(mask), method=run)
    with torch.no_grad():
        sparse, dense = model.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(lbl),
                                             None if mask is None else torch.from_numpy(mask))
        ours = (sparse, dense, model.prompt_encoder.dense_pe(grid))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(_np(o), np.asarray(t), atol=5e-4, rtol=5e-4)


def test_mask_decoder(tiny):
    params, model, _ = tiny
    grid = IMG // 16
    rng = np.random.default_rng(7)
    emb, pe, dense = (rng.standard_normal((grid, grid, 256)).astype(np.float32) * 0.5 for _ in range(3))
    sparse = rng.standard_normal((jsam.MAX_POINTS, 256)).astype(np.float32) * 0.5
    theirs = jsam.MaskDecoder().apply({"params": params["params"]["mask_decoder"]}, *map(jnp.asarray, (emb, pe, sparse, dense)))
    with torch.no_grad():
        ours = model.mask_decoder(*map(torch.from_numpy, (emb, pe, sparse, dense)))
    assert ours[0].shape == (4, grid * 4, grid * 4) and ours[1].shape == (4,)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(_np(o), np.asarray(t), atol=5e-4, rtol=5e-4)


def test_sam_decode_from_jax_init():
    """`Sam.decode` with the JAX package's own initialisation, `pos_embed`
    and the rel-pos tables set random, carried over by
    `sam_state_dict_from_jax` and loaded strictly."""
    grid = IMG // 16
    rng = np.random.default_rng(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "IMG_SIZE", IMG)
        jmodel = jsam.Sam(variant="vit_test")
        params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((8, 2)),
                             jnp.zeros((8,), jnp.int32), jnp.zeros((grid * 4, grid * 4)))
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1)
            if jax.tree_util.keystr(path).endswith(("'pos_embed']", "'rel_pos_h']", "'rel_pos_w']")) else x, params)
        x = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
        pts = np.concatenate([rng.uniform(0, IMG, (5, 2)), np.zeros((3, 2))]).astype(np.float32)
        lbl = np.array([1, 1, 0, 2, 3, -1, -1, -1], np.int32)
        mask = rng.standard_normal((grid * 4, grid * 4)).astype(np.float32)
        emb = jmodel.apply(params, jnp.asarray(x), method=jsam.Sam.encode_image)[0]
        theirs = jmodel.apply(params, emb, jnp.asarray(pts), jnp.asarray(lbl), jnp.asarray(mask), method=jsam.Sam.decode)
    model = tsam.Sam("vit_test", img_size=IMG)
    model.load_state_dict(sam_state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        ours = model.decode(model.encode_image(torch.from_numpy(x))[0], torch.from_numpy(pts), torch.from_numpy(lbl),
                            torch.from_numpy(mask))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(_np(o), np.asarray(t), atol=5e-4, rtol=5e-4)


def test_every_layernorm_takes_flax_eps(tiny):
    """Each of the port's norms (ViT, neck, prompt encoder, decoder) against
    flax's LayerNorm at its default eps on inputs of variance ~1e-6, where
    eps 1e-5 (the official decoder's) would be off by half."""
    import flax.linen as fnn

    from multiply_tpu_torch.models.sam import LayerNorm2d

    _, model, _ = tiny
    rng = np.random.default_rng(9)
    norms = [(n, m) for n, m in model.named_modules() if isinstance(m, (torch.nn.LayerNorm, LayerNorm2d))]
    assert len(norms) == 2 * 2 + 2 + 2 + 1 + 4 * 2 + 1  # blocks, neck, mask input, upscaling, decoder
    for name, m in norms:
        C = m.weight.shape[0]
        x = (rng.standard_normal((5, C)) * 1e-3).astype(np.float32)
        w, b = m.weight.detach().numpy(), m.bias.detach().numpy()
        theirs = fnn.LayerNorm().apply({"params": {"scale": w, "bias": b}}, jnp.asarray(x))
        with torch.no_grad():
            xt = torch.from_numpy(x)
            ours = m(xt) if isinstance(m, torch.nn.LayerNorm) else m(xt[:, :, None, None])[:, :, 0, 0]
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=1e-4, rtol=1e-3, err_msg=name)
