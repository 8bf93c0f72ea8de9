"""The port's epoch-end stages and their pieces against the JAX package.

Mesh extraction of an analytic SDF, the largest component and PLY files;
the instance-mask stage and `PriorSegmenter`'s files from given meshes; the
JET table of the depth-map dumps against OpenCV; `_select_mode` and
`_pose_window` over a grid of epochs, certainty, SAM and configs; mesh
padding; `pose_loss_batch`'s pixel draw; the SMPL-init samples and one
pretraining step; a validation render (`Evaluator.render_image`). The JAX
side's K=1 search runs through direct differences, as the TPU kernel
computes it (`_torch_helpers.direct_knn`).
"""

import itertools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_update_matches, direct_knn, npify, tiny_conf, tiny_program, tiny_scene  # noqa: F401
from multiply_tpu.engine import instance_masks as j_masks
from multiply_tpu.engine import mesh_export as j_mesh
from multiply_tpu.engine import sam_stage as j_sam
from multiply_tpu.engine import trainer as j_trainer
from multiply_tpu_torch import convert
from multiply_tpu_torch.engine import instance_masks as t_masks
from multiply_tpu_torch.engine import mesh_export as t_mesh
from multiply_tpu_torch.engine import sam_stage as t_sam
from multiply_tpu_torch.engine import trainer as t_trainer


def _two_spheres(pts):
    a = np.linalg.norm(pts - np.array([-0.3, 0.05, 0.0]), axis=-1) - 0.35
    b = np.linalg.norm(pts - np.array([0.45, -0.1, 0.05]), axis=-1) - 0.2
    return np.minimum(a, b).astype(np.float32)


HINT = np.array([[-0.8, -0.6, -0.5], [0.8, 0.6, 0.5]], np.float32)


@pytest.mark.parametrize("largest", [True, False])
def test_generate_mesh_of_an_analytic_sdf_matches_jax(largest):
    v, f = t_mesh.generate_mesh(_two_spheres, HINT, res_up=1, largest_component=largest)
    jv, jf = j_mesh.generate_mesh(_two_spheres, HINT, res_up=1, largest_component=largest)
    assert len(f) > 100
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-6)


def test_keep_largest_component_matches_jax():
    rng = np.random.default_rng(0)
    verts, faces, base = [], [], 0
    for n in (5, 40, 12):  # three strips of triangles, vertex order shuffled below
        verts.append(rng.standard_normal((n + 2, 3)))
        faces += [[base + i, base + i + 1, base + i + 2] for i in range(n)]
        base += n + 2
    verts, faces = np.concatenate(verts).astype(np.float32), np.asarray(faces)
    perm = rng.permutation(len(verts))
    inv = np.argsort(perm)
    verts, faces = verts[perm], inv[faces]
    v, f = t_mesh.keep_largest_component(verts, faces)
    jv, jf = j_mesh.keep_largest_component(verts, faces)
    assert len(f) == 40
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_save_ply_reads_back_in_both_packages(tmp_path):
    v, f = t_mesh.generate_mesh(_two_spheres, HINT, res_up=0)
    path = str(tmp_path / "m.ply")
    t_mesh.save_ply(path, v, f)
    jpath = str(tmp_path / "j.ply")
    j_mesh.save_ply(jpath, v, f)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    for load in (t_mesh.load_ply, j_mesh.load_ply):
        lv, lf = load(path)
        np.testing.assert_allclose(lv, v, atol=1e-6)
        np.testing.assert_array_equal(lf, f)


def test_instance_mask_stage_and_prior_segmenter_match_jax(tmp_path):
    """From the same posed meshes: the masks, the keypoints and the SAM
    stage's logits, file for file."""
    scene = tiny_scene()
    H, W = scene.height, scene.width
    P_mat = np.eye(4, dtype=np.float32)
    P_mat[:3, :4] = scene.intrinsics @ np.linalg.inv(scene.cam_pose[0])[:3, :4]
    frames = []
    for f in range(scene.images.shape[0]):
        meshes, joints = [], []
        for p, server in enumerate(scene.servers):
            out = server(jnp.asarray(1.0), jnp.asarray(scene.transl[f, p]), jnp.asarray(scene.poses[f, p]),
                         jnp.asarray(scene.betas[p]))
            meshes.append((np.asarray(out["smpl_verts"]), np.asarray(server.model.faces)))
            joints.append(np.asarray(out["smpl_all_jnts"]))
        frames.append({"P": P_mat, "img_size": (H, W), "meshes": meshes, "joints": joints})
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    masks, kps = t_masks.run_instance_mask_stage(50, frames, out_dir=t_dir)
    jmasks, jkps = j_masks.run_instance_mask_stage(50, frames, out_dir=j_dir)
    assert masks.any() and masks.shape == (2, 2, H, W)
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(kps, jkps)
    logits = t_sam.PriorSegmenter()(50, run_dir=t_dir)
    jlogits = j_sam.PriorSegmenter()(50, run_dir=j_dir)
    np.testing.assert_array_equal(logits, jlogits)
    for rel in ("stage_instance_mask/00050/all_person_smpl_mask.npy", "stage_instance_mask/00050/2d_keypoint.npy",
                "stage_sam_mask/00050/sam_opt_mask.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(t_dir, rel)), np.load(os.path.join(j_dir, rel)))


def test_jet_table_and_depth_colormap_match_cv2():
    levels = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(t_trainer.JET_RGB[None], cv2.applyColorMap(levels, cv2.COLORMAP_JET)[..., ::-1])
    depth = np.random.default_rng(0).uniform(2.0, 5.5, (17, 23))
    depth[0, :3] = 999.0  # a miss
    d8 = ((np.clip(depth, 2.5, 5.0) - 2.5) / 2.5 * 255).astype(np.uint8)
    want = cv2.applyColorMap(255 - d8, cv2.COLORMAP_JET)[..., ::-1]  # what cv2.imwrite puts in the file, as RGB
    np.testing.assert_array_equal(t_trainer.depth_colormap(depth), want)


# ---------------------------------------------------------------------------
# mode schedule, padding
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(depth_end=False, using_sam=True, pose_start_epoch=200, pose_end_epoch=1000, pose_opt_interval=10,
         pose_opt_epoch=1, pose_correction_epoch=500),
    dict(depth_end=True, using_sam=True, pose_start_epoch=200, pose_end_epoch=1000, pose_opt_interval=10,
         pose_opt_epoch=1, pose_correction_epoch=500),
    dict(depth_end=False, using_sam=False, pose_start_epoch=1, pose_end_epoch=50, pose_opt_interval=1,
         pose_opt_epoch=1, pose_correction_epoch=24),
    dict(depth_end=False, using_sam=True, pose_start_epoch=1, pose_end_epoch=50, pose_opt_interval=3,
         pose_opt_epoch=2, pose_correction_epoch=24),
]


def _scheduled(cls, schedule, epoch):
    obj = object.__new__(cls)
    obj.__dict__.update(schedule, epoch=epoch)
    return obj


@pytest.mark.parametrize("schedule", range(len(SCHEDULES)))
@pytest.mark.parametrize("epoch", [0, 1, 2, 19, 23, 24, 30, 49, 50, 199, 200, 201, 210, 499, 500, 999, 1000])
def test_select_mode_matches_jax(schedule, epoch):
    s = SCHEDULES[schedule]
    port, jax_tr = _scheduled(t_trainer.Trainer, s, epoch), _scheduled(j_trainer.Trainer, s, epoch)
    assert port._pose_window() == jax_tr._pose_window()
    for certain, has_sam in itertools.product((True, False), repeat=2):
        assert port._select_mode(certain, has_sam) == jax_tr._select_mode(certain, has_sam)


@pytest.mark.parametrize("n", [0, 1, 100, 8192, 8193, 20000, 70000])
def test_mesh_padding_matches_jax(n):
    assert t_trainer._bucket_size(n, 8192) == j_trainer._bucket_size(n, 8192)
    rng = np.random.default_rng(n)
    verts = rng.standard_normal((n, 3)).astype(np.float32)
    faces = rng.integers(0, max(n, 1), (n // 2, 3))
    for got, want in zip(t_trainer._pad_mesh(verts, faces, 1024), j_trainer._pad_mesh(verts, faces, 1024)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_trainer._pad_mesh_to(verts, faces, n + 5, n // 2 + 3),
                         j_trainer._pad_mesh_to(verts, faces, n + 5, n // 2 + 3)):
        np.testing.assert_array_equal(got, want)


def test_pose_loss_batch_pixel_draw_matches_jax(monkeypatch):
    """The same SAM-confident pixels, probabilities and rescale from the same
    generator, with the meshes given."""
    scene = tiny_scene()
    P = len(scene.servers)
    rng = np.random.default_rng(3)
    meshes = [(rng.standard_normal((300 + 50 * p, 3)).astype(np.float32), rng.integers(0, 300, (500, 3)))
              for p in range(P)]
    sam = np.where(scene.masks, 8.0, -8.0).astype(np.float32)
    sam[0, :3] = 0.3  # unconfident: both persons near 0.5
    seq = type("Seq", (), {"_sam_masks": sam})()
    body_pose = np.zeros((P, 2, 69), np.float32)
    common = dict(seq=seq, num_person=P, pose_pixel_samples=4000, mesh_pad_bucket=256)

    jtr = _scheduled(j_trainer.Trainer, common, 0)
    jtr.canonical_sdf_fn = lambda p, cond, params=None: p
    jtr.servers = scene.servers
    monkeypatch.setattr(j_trainer, "generate_mesh", lambda p, hint, res_up: meshes[p])
    jtr.mesh_res_up = 2
    ttr = _scheduled(t_trainer.Trainer, common, 0)
    ttr.device = torch.device("cpu")
    ttr._canonical_mesh = lambda p, cond, params=None: meshes[p]

    from multiply_tpu.body.params import BodyParamTable as JaxTable

    jbody = JaxTable(np.zeros((P, 1, 10)), np.zeros((P, 2, 3)), np.zeros((P, 2, 3)), body_pose)
    jb = jtr.pose_loss_batch(0, np.random.default_rng(7), params={"body": jbody})
    tb = ttr.pose_loss_batch(0, np.random.default_rng(7), params={"body.body_pose": torch.tensor(body_pose)})
    np.testing.assert_array_equal(tb.uv.numpy(), np.asarray(jb.uv))
    np.testing.assert_array_equal(tb.sam_probs.numpy(), np.asarray(jb.sam_probs))
    assert tb.scale_to_full == pytest.approx(float(jb.scale_to_full), rel=1e-7)
    np.testing.assert_array_equal(tb.verts_c.numpy(), np.asarray(jb.verts_c))
    np.testing.assert_array_equal(tb.faces.numpy(), np.asarray(jb.faces))


# ---------------------------------------------------------------------------
# SMPL init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smpl_init_pair():
    from multiply_tpu.config import Config as JaxConfig
    from multiply_tpu.models.networks import ImplicitNet as JaxNet
    from multiply_tpu_torch.config import Config
    from multiply_tpu_torch.models.networks import ImplicitNet

    conf = tiny_conf()["implicit_network"]
    jnet = JaxNet.from_config(JaxConfig(conf))
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((69,)))
    net = ImplicitNet.from_config(Config(conf), device="cpu")
    named = {f"net.fg_implicit.{k}": p for k, p in net.named_parameters()}
    convert.load_params(named, {"net": {"fg_implicit": npify(jparams)}})
    server = convert.server_from_jax(npify(tiny_scene().servers[0]), device="cpu")
    return jnet, jparams, net, server


def test_sample_training_points_match_jax(smpl_init_pair):
    from multiply_tpu.engine.smpl_init import sample_training_points as j_sample
    from multiply_tpu_torch.engine.smpl_init import sample_training_points

    jnet, _, _, server = smpl_init_pair
    pts, gt = sample_training_points(server, 777, np.random.default_rng(5))
    jpts, jgt = j_sample(tiny_scene().servers[0], 777, np.random.default_rng(5))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_allclose(gt, np.asarray(jgt), atol=1e-5)


def test_smpl_init_cache_reads_in_both_packages(smpl_init_pair, tmp_path):
    from multiply_tpu.engine.smpl_init import load_init as j_load_init
    from multiply_tpu.engine.smpl_init import save_init as j_save_init
    from multiply_tpu_torch.engine import smpl_init

    jnet, jparams, net, _ = smpl_init_pair
    params = {k: p.detach() for k, p in net.named_parameters()}
    smpl_init.save_init(str(tmp_path / "port.npz"), params)
    back = npify(j_load_init(str(tmp_path / "port.npz")))
    jax.tree.map(np.testing.assert_array_equal, back, npify(jparams))
    j_save_init(str(tmp_path / "jax.npz"), npify(jparams))
    for name, value in smpl_init.load_init(str(tmp_path / "jax.npz"), net).items():
        assert torch.equal(value, params[name]), name


def smpl_init_one_step(smpl_init_pair, monkeypatch):
    """One step of SMPL-init pretraining on both sides, from the same weights,
    batch and perturbation: (port loss, JAX loss, and per leaf in pytree layout
    {name: (port gradient, JAX gradient, before, port after, JAX after)}). The
    port's weights are put back after the step."""
    from multiply_tpu.engine.smpl_init import pretrain_smpl_init as j_pretrain
    from multiply_tpu_torch.engine import smpl_init

    jnet, jparams, net, server = smpl_init_pair
    pool, batch, lr = 600, 128, 1e-4
    rng = np.random.default_rng(0)
    pts_pool, sdf_pool = smpl_init.sample_training_points(server, pool, rng)
    sel = rng.integers(0, pool, batch)
    _, k = jax.random.split(jax.random.PRNGKey(1))
    noise = np.asarray(jax.random.normal(k, (batch, 3))) * 0.01
    pts, gt = pts_pool[sel], sdf_pool[sel]
    cond = jnp.zeros((69,))

    def jloss(p):
        pred = jnet.apply(p, jnp.asarray(pts), cond)[:, 0]
        g = jax.grad(lambda x: jnp.sum(jnet.apply(p, x, cond)[:, 0]))(jnp.asarray(pts + noise))
        return jnp.mean(jnp.abs(pred - gt)) + 0.1 * jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    loss, _, _ = smpl_init.smpl_init_loss(net, torch.tensor(pts), torch.tensor(gt), torch.tensor(noise))
    params = dict(net.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    # one step of the real loops: the JAX package draws its perturbation from its key path
    monkeypatch.setattr(smpl_init, "draw_perturbation", lambda shape, gen, dev: torch.tensor(noise))
    before = {k: p.detach().clone() for k, p in params.items()}
    new = smpl_init.pretrain_smpl_init(net, server, steps=1, batch=batch, lr=lr, pool=pool)
    jnew = j_pretrain(jnet, tiny_scene().servers[0], steps=1, batch=batch, lr=lr, pool=pool)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(before[k])
    leaves = {}
    for name in params:
        full = f"net.fg_implicit.{name}"
        leaves[name] = (
            convert.to_flax_layout(full, grads[name]),
            convert.flax_leaf({"net": {"fg_implicit": npify(jgrads)}}, full),
            convert.to_flax_layout(full, before[name]),
            convert.to_flax_layout(full, new[name]),
            convert.flax_leaf({"net": {"fg_implicit": npify(jnew)}}, full),
        )
    return float(loss.detach()), float(jval), leaves, lr


def test_smpl_init_step_matches_jax(smpl_init_pair, monkeypatch):
    """One step's loss and gradients on the same batch and perturbation, and
    each weight's change over one step of `pretrain_smpl_init` on both sides,
    within a tenth of the step (`assert_update_matches`)."""
    loss, jloss, leaves, lr = smpl_init_one_step(smpl_init_pair, monkeypatch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    exempt = 0
    for name, (g, jg, before, got, want) in leaves.items():
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max() + 1e-7, name
        exempt += assert_update_matches(name, before, got, want, [jg], [g], lr)
    assert exempt <= 0.01 * sum(v[0].size for v in leaves.values()), exempt


@pytest.mark.parametrize("fault", ["no-op", "sign-flip"])
def test_planted_adam_fault_fails_the_update_check(smpl_init_pair, monkeypatch, fault):
    """The update check of the parity tests sees an Adam that moves nothing
    or moves the wrong way: planted in the port's SMPL-init step, each fails
    it on some leaf."""
    from multiply_tpu_torch.engine import smpl_init

    adam_update = smpl_init.adam_update

    def planted(grads, state, params, *args, **kw):
        before = {k: p.detach().clone() for k, p in params.items()}
        state = adam_update(grads, state, params, *args, **kw)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(before[k] if fault == "no-op" else 2 * before[k] - p)
        return state

    monkeypatch.setattr(smpl_init, "adam_update", planted)
    _, _, leaves, lr = smpl_init_one_step(smpl_init_pair, monkeypatch)
    failed = []
    for name, (g, jg, before, got, want) in leaves.items():
        try:
            assert_update_matches(name, before, got, want, [jg], [g], lr)
        except AssertionError:
            failed.append(name)
    assert len(failed) == len(leaves), f"the planted {fault} update passed on {set(leaves) - set(failed)}"


# ---------------------------------------------------------------------------
# validation render
# ---------------------------------------------------------------------------


def test_evaluator_render_image_matches_jax(direct_knn):
    from multiply_tpu.engine.evaluator import Evaluator as JaxEvaluator
    from multiply_tpu_torch.engine.evaluator import Evaluator

    (jr, jstate, _, jts, _), (renderer, state, _, ts, _) = tiny_program(tiny_conf())
    scene = tiny_scene()
    H, W = scene.height, scene.width
    uv = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(-1, 2).astype(np.float32)
    item = {"uv": uv, "rgb": scene.images[1].reshape(-1, 3), "pose": scene.cam_pose[1],
            "intrinsics": scene.intrinsics, "smpl_scale": scene.scale, "idx": 1, "img_size": (H, W)}
    want = JaxEvaluator(jr, jstate, scene.servers, pixel_per_batch=256).render_image(
        jts.params["net"], jts.params["body"], item, epoch=30)
    got = Evaluator(renderer, state, [], pixel_per_batch=200).render_image(ts.body, item, epoch=30)
    for k in ("rgb_image", "fg_image", "normal_image", "mask_image", "instance_images"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
