"""SAM weights in the port: the official key layout, the strict loader and the
JAX -> official state-dict carry.

The official keys and shapes of `vit_b`, `vit_l` and `vit_h` are frozen in
`tests/data/sam_manifests/`; the port's `Sam` is built on the `meta` device,
so `vit_h` allocates nothing. `convert.sam_state_dict_from_jax` is the inverse
of the JAX package's `port_torch_checkpoint`: official -> JAX -> official
gives back every tensor exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_sam as oracle
import multiply_tpu.models.sam as jsam
from multiply_tpu_torch.convert import sam_state_dict_from_jax
from multiply_tpu_torch.models import sam as tsam

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "data", "sam_manifests")


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h"])
def test_meta_model_has_every_official_key_and_shape(variant):
    with open(os.path.join(MANIFEST_DIR, f"{variant}.json")) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    with torch.device("meta"):
        model = tsam.Sam(variant)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest
    assert all(v.is_meta for v in model.state_dict().values())


@pytest.mark.parametrize("variant, img", [("vit_test", 128), ("vit_b2", 1024)])
def test_official_to_jax_to_official_round_trip_is_exact(variant, img, tmp_path, monkeypatch):
    monkeypatch.setattr(jsam, "IMG_SIZE", img)
    sd = oracle.make_state_dict(jsam.VIT_CONFIGS[variant], img, seed=3)
    path = str(tmp_path / "sam.pth")
    torch.save(sd, path)
    back = sam_state_dict_from_jax(jsam.port_torch_checkpoint(path, variant))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_jax_tree_with_a_leaf_left_over_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(jsam, "IMG_SIZE", 128)
    sd = oracle.make_state_dict(jsam.VIT_CONFIGS["vit_test"], 128)
    torch.save(sd, tmp_path / "sam.pth")
    params = jsam.port_torch_checkpoint(str(tmp_path / "sam.pth"), "vit_test")
    params["params"]["mask_decoder"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left over"):
        sam_state_dict_from_jax(params)


def test_loader_is_strict_and_resizes_rel_pos(tmp_path):
    """`build_sam_predictor` loads with strict=True: a key left over or
    missing raises. A rel-pos table of another length is resized linearly
    once, as the JAX package's port does (against its `jax.image.resize`)."""
    sd = oracle.make_state_dict(tsam.VIT_CONFIGS["vit_b2"], 1024, seed=4)
    short = torch.randn(63, 64, generator=torch.Generator().manual_seed(0))
    sd["image_encoder.blocks.1.attn.rel_pos_h"] = short
    torch.save(sd, tmp_path / "ok.pth")
    pred = tsam.build_sam_predictor(str(tmp_path / "ok.pth"), "vit_b2", device="cpu")
    loaded = pred.model.image_encoder.blocks[1].attn.rel_pos_h
    assert loaded.shape == (127, 64)
    theirs = jsam.port_torch_checkpoint(str(tmp_path / "ok.pth"), "vit_b2")["params"]
    np.testing.assert_allclose(loaded.detach().numpy(), theirs["image_encoder"]["block1"]["attn"]["rel_pos_h"],
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(pred.model.image_encoder.blocks[0].attn.qkv.weight, sd["image_encoder.blocks.0.attn.qkv.weight"])

    extra = dict(sd, **{"image_encoder.extra_tensor": torch.zeros(3)})
    torch.save(extra, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="extra_tensor"):
        tsam.build_sam_predictor(str(tmp_path / "extra.pth"), "vit_b2", device="cpu")
    missing = {k: v for k, v in sd.items() if k != "mask_decoder.iou_token.weight"}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="iou_token"):
        tsam.build_sam_predictor(str(tmp_path / "missing.pth"), "vit_b2", device="cpu")


def test_random_sam_draws_the_jax_initialisers_distributions():
    """Seeded: the same generator gives the same weights. Kernels have
    variance 1/fan_in, biases and `pos_embed` are zero, norms one."""
    a = tsam.random_sam("vit_test", torch.Generator().manual_seed(1), device="cpu", img_size=128)
    b = tsam.random_sam("vit_test", torch.Generator().manual_seed(1), device="cpu", img_size=128)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["mask_decoder.transformer.layers.0.mlp.lin2.weight"]  # fan_in 2048
    assert abs(float(w.var()) * 2048 - 1.0) < 0.05
    assert float(sa["image_encoder.patch_embed.proj.weight"].var()) * 768 == pytest.approx(1.0, abs=0.1)
    assert not sa["image_encoder.blocks.0.attn.qkv.bias"].any() and not sa["image_encoder.pos_embed"].any()
    assert torch.equal(sa["image_encoder.neck.1.weight"], torch.ones(256))
    assert abs(float(sa["mask_decoder.mask_tokens.weight"].std()) - 1.0) < 0.1


@pytest.mark.parametrize("build", ["meta", "random_sam", "load_sam"])
def test_building_sam_turns_tf32_off(build, tmp_path, monkeypatch):
    """The SAM model owns its precision: however it is built, TF32 is off
    for products and convolutions afterwards, even where it was on."""
    path = tmp_path / "sam.pth"
    if build == "load_sam":
        torch.save(tsam.random_sam("vit_test", torch.Generator().manual_seed(0), device="cpu").state_dict(), path)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if build == "meta":
        with torch.device("meta"):
            tsam.Sam("vit_h")
    elif build == "random_sam":
        tsam.random_sam("vit_test", torch.Generator().manual_seed(0), device="cpu")
    else:
        tsam.load_sam(str(path), "vit_test", device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
