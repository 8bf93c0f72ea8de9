"""The port's training program on the CPU at tiny widths: `Trainer.fit`
across the epoch-end stages, a delayed-pose epoch, checkpoints, and the
training and test entries (`multiply_tpu_torch.cli`). No JAX here: what these
tests hold is the control flow and the files the program writes."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from multiply_tpu_torch.cli import test as cli_test
from multiply_tpu_torch.cli import train as cli_train
from multiply_tpu_torch.config import load_config
from multiply_tpu_torch.engine.evaluator import Evaluator
from multiply_tpu_torch.engine.mesh_export import load_ply
from multiply_tpu_torch.engine.sam_stage import PriorSegmenter, SamSegmenter
from multiply_tpu_torch.engine.train import MODE_DELAYED_POSE, MODE_JOINT
from multiply_tpu_torch.models import sam as sam_model
from multiply_tpu_torch.utils.io import read_png

CONF = os.path.join(os.path.dirname(__file__), "..", "confs", "synthetic_base.yaml")
TINY = (
    "model.implicit_network.dims=[32,32]", "model.implicit_network.skip_in=[]", "model.implicit_network.multires=2",
    "model.implicit_network.feature_vector_size=32", "model.rendering_network.dims=[32]",
    "model.rendering_network.feature_vector_size=32", "model.bg_implicit_network.dims=[32,32]",
    "model.bg_implicit_network.multires=2", "model.bg_implicit_network.feature_vector_size=32",
    "model.bg_rendering_network.dims=[16]", "model.bg_rendering_network.feature_vector_size=32",
    "model.ray_sampler={N_samples: 8, N_samples_eval: 16, N_samples_extra: 4, beta_iters: 3, max_total_iters: 2, "
    "N_samples_inverse_sphere: 4, near: 0.0, eps: 0.1, add_tiny: 1.0e-6}",
    "model.dim_frame_encoding=8", "model.depth_epoch=[20]", "model.it_per_loop=2", "model.depth_render_rays=32",
    "model.depth_pixel_samples=96", "model.pose_pixel_samples=64", "model.interp_samples=48",
    "model.mesh_pad_bucket=1024", "model.num_training_frames=2", "model.cano_grid_res=8",
    "model.cano_mesh_res_up=0", "model.learning_rate=1.0e-4", "dataset.train.num_sample=40",
    "dataset.train.end_frame=2", "dataset.train.height=20", "dataset.train.width=24",
    "dataset.valid.pixel_per_batch=256", "dataset.test.pixel_per_batch=256",
)


def argv(run_dir, *more, sets=()):
    return ["--conf", CONF, "--run_dir", str(run_dir), "--device", "cpu", *more,
            *(f"--set={s}" for s in (*TINY, *sets))]


def build(run_dir, sets=()):
    return cli_train.build_trainer(cli_train.parse_args(argv(run_dir, sets=sets)))


@pytest.mark.parametrize("overlap", [False, True])
def test_fit_crosses_the_epoch_0_and_20_stages(tmp_path, overlap):
    """Epoch 0: instance masks, SAM stage, validation render and meshes,
    checkpoint. Epoch 20: mesh refresh (the step then reads the new grid) and
    opt_depth with its depth-map dumps. Then `last`."""
    tr, _, ckpt_dir = build(tmp_path, sets=(f"model.stage_overlap={overlap}",))
    grid = tr.person_state.cano_grid["grid"].clone()
    tr.fit(1, ckpt_dir=ckpt_dir)
    tr.epoch = 20
    body = tr.ts.body.transl.detach().clone()
    tr.fit(21, ckpt_dir=ckpt_dir)
    files = [
        "stage_instance_mask/00000/all_person_smpl_mask.npy", "stage_instance_mask/00000/2d_keypoint.npy",
        "stage_sam_mask/00000/sam_opt_mask.npy", "val/epoch_00000.png", "val/epoch_00000_person_0.ply",
        "val/epoch_00000_person_1.ply", "checkpoints/epoch_00000", "checkpoints/last", "metrics.jsonl",
        *(f"stage_depth_map/00020/{it:05d}/{kind}/{kind}_{f:04d}.png"
          for it in (0, 1) for kind in ("front", "gt") for f in (0, 1)),
    ]
    missing = [f for f in files if not os.path.exists(os.path.join(tmp_path, f))]
    assert not missing, missing
    assert read_png(os.path.join(tmp_path, "val", "epoch_00000.png")).shape == (20, 48, 3)
    verts, faces = load_ply(os.path.join(tmp_path, "val", "epoch_00000_person_0.ply"))
    assert len(verts) > 50 and len(faces) > 50
    new = tr.person_state.cano_grid["grid"]
    assert tr.builder.state.cano_grid["grid"] is new
    assert all(not torch.equal(grid[p], new[p]) for p in range(2)), "mesh refresh left a grid as it was"
    assert not torch.equal(body, tr.ts.body.transl.detach()), "opt_depth moved no translation"
    assert tr.epoch == 21 and torch.load(os.path.join(ckpt_dir, "last"), weights_only=True)["epoch"] == 21


def test_delayed_pose_epoch_uses_edge_rays(tmp_path):
    """A SAM mask that disagrees with the instance mask makes its frame
    uncertain: that frame's step is delayed-pose, with the edge-sampled rays,
    and leaves the shape networks alone."""
    tr, _, _ = build(tmp_path)
    tr.instance_mask_stage()
    tr.sam_stage()
    path = os.path.join(tmp_path, "stage_sam_mask", "00000", "sam_opt_mask.npy")
    sam = np.load(path)
    sam[1, 0] = -8.0  # frame 1, person 0: SAM finds no one
    np.save(path, sam)
    items, batches = {}, []
    get_item, step = tr.seq.get_train_item, tr.builder.step
    tr.seq.get_train_item = lambda i, rng: items.setdefault(i, get_item(i, rng))
    tr.builder.step = lambda ts, batch, **kw: (batches.append(batch), step(ts, batch, **kw))[1]
    tr.epoch = 1
    out = tr.train_epoch()
    assert (out["n_joint"], out["n_delayed_pose"], out["n_pose_only"]) == (1.0, 1.0, 0.0)
    assert not items[1]["is_certain"] and items[0]["is_certain"]
    delayed = next(b for b in batches if b.mode == MODE_DELAYED_POSE)
    joint = next(b for b in batches if b.mode == MODE_JOINT)
    assert delayed.frame_idx == 1 and joint.frame_idx == 0
    np.testing.assert_array_equal(delayed.uv.numpy(), items[1]["edge_uv"])
    np.testing.assert_array_equal(delayed.sam_mask.numpy(), items[1]["edge_sam_mask"])
    counts = tr.ts.opt_joint.count
    assert counts["net.fg_implicit.lins.0.weight"] == 1 and counts["net.frame_latent"] == 2
    assert counts["body.transl"] == 2


def test_checkpoint_round_trip(tmp_path):
    tr, _, ckpt_dir = build(tmp_path)
    tr.train_epoch()
    tr.epoch = 7
    tr.save_checkpoint(ckpt_dir)
    assert os.listdir(ckpt_dir) == ["epoch_00007"]
    saved = {k: p.detach().clone() for k, p in tr.ts.params().items()}
    mu = {k: v.clone() for k, v in tr.ts.opt_joint.mu.items()}
    counts = dict(tr.ts.opt_pose.count)
    with torch.no_grad():
        for p in tr.ts.params().values():
            p.add_(1.0)
    tr.ts.opt_joint.mu["net.beta"].add_(1.0)
    tr.epoch = 0
    fresh, _, _ = build(tmp_path)
    for t in (tr, fresh):
        t.load_checkpoint(os.path.join(ckpt_dir, "epoch_00007"))
        assert t.epoch == t.ts.epoch == 7
        assert all(torch.equal(p, saved[k]) for k, p in t.ts.params().items())
        assert all(torch.equal(v, mu[k]) for k, v in t.ts.opt_joint.mu.items())
        assert t.ts.opt_pose.count == counts and max(counts.values()) == 0
        assert all(p.requires_grad for p in t.ts.params().values())


def test_entries_train_then_render(tmp_path):
    """`cli.train` for one epoch, then `cli.test` from its checkpoint: default
    mode with the ground truth beside the render, and free view."""
    trainer = cli_train.main(argv(tmp_path, "--max_epochs", "1"))
    assert trainer.epoch == 1
    assert os.path.exists(os.path.join(tmp_path, "checkpoints", "last"))
    out_dir = cli_test.main(argv(tmp_path, "--frames", "2"))
    for sub in ("test_rendering", "test_fg_rendering", "test_normal", "test_mask", "test_instance_mask/0",
                "test_instance_mask/1"):
        for f in (0, 1):
            assert os.path.exists(os.path.join(out_dir, sub, f"{f:04d}.png")), (sub, f)
    assert read_png(os.path.join(out_dir, "test_rendering", "0000.png")).shape == (20, 48, 3)
    cli_test.main(argv(tmp_path, "--frames", "1", "--mode", "free_view"))
    assert read_png(os.path.join(out_dir, "test_rendering", "0000.png")).shape == (20, 24, 3)


def test_export_meshes_writes_canonical_and_deformed(tmp_path):
    tr, _, _ = build(tmp_path)
    ev = Evaluator(tr.renderer, tr.person_state, tr.servers)
    fns = [tr.canonical_sdf_fn(p) for p in range(tr.num_person)]
    ev.export_meshes(fns, tr.ts.body, tr.person_state.deformer, 1, 1.0, str(tmp_path), res_up=0)
    for p in range(tr.num_person):
        vc, fc = load_ply(os.path.join(tmp_path, "test_mesh", str(p), "0001_canonical.ply"))
        vd, fd = load_ply(os.path.join(tmp_path, "test_mesh", str(p), "0001_deformed.ply"))
        assert len(vc) == len(vd) > 50 and np.array_equal(fc, fd)
        assert not np.allclose(vc, vd)


@pytest.mark.parametrize("flags", [("--devices", "2")])
def test_train_entry_refuses_what_is_not_ported(tmp_path, flags):
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli_train.main(argv(tmp_path, *flags))


def test_train_entry_profiles_steps_and_exits(tmp_path):
    """`--profile 2`: two warm steps, two traced, the table written to
    <run_dir>/profile/summary.json, and no training run after it."""
    trainer = cli_train.main(argv(tmp_path, "--profile", "2"))
    with open(os.path.join(tmp_path, "profile", "summary.json")) as f:
        summary = json.load(f)
    assert summary["steps"] == 2 and summary["wall_s"] > 0 and isinstance(summary["rows"], list)
    assert os.path.exists(os.path.join(tmp_path, "profile", "trace.json"))
    assert trainer.epoch == 0 and not os.path.exists(os.path.join(tmp_path, "checkpoints"))


def test_train_entry_without_the_sam_checkpoint_uses_the_prior(tmp_path):
    tr, _, _ = build(tmp_path, sets=(f"sam_checkpoint={tmp_path / 'missing.pth'}",))
    assert isinstance(tr.segmenter, PriorSegmenter)


def test_train_entry_with_a_sam_checkpoint_uses_sam(tmp_path, monkeypatch):
    """An existing checkpoint (here `vit_test` in the official layout, through
    a patched `build_sam_predictor`, since the entry asks for vit_h) gives a
    `SamSegmenter` over the frames as uint8, rgb x 255 truncated; its stage
    writes the refined logits at the frame size."""
    path = tmp_path / "sam_vit_test.pth"
    torch.save(sam_model.random_sam("vit_test", torch.Generator().manual_seed(0), device="cpu").state_dict(), path)
    asked = []

    def build_predictor(checkpoint, variant="vit_h", device="cuda"):
        asked.append((checkpoint, variant, device))
        return sam_model.SamPredictor(sam_model.load_sam(checkpoint, "vit_test", device))

    monkeypatch.setattr(sam_model, "build_sam_predictor", build_predictor)
    tr, _, _ = build(tmp_path / "run", sets=(f"sam_checkpoint={path}",))
    assert isinstance(tr.segmenter, SamSegmenter) and asked == [(str(path), "vit_h", "cpu")]
    assert len(tr.segmenter.images) == len(tr.seq)
    rounded_somewhere = False
    for i, image in enumerate(tr.segmenter.images):
        item = tr.seq.get_eval_item(i)
        rgb = item["rgb"].reshape(*item["img_size"], 3) * 255
        frame = image()
        assert frame.dtype == np.uint8 and frame.shape == (20, 24, 3)
        np.testing.assert_array_equal(frame, np.floor(rgb).astype(np.uint8))
        rounded_somewhere |= bool((np.round(rgb).astype(np.uint8) != frame).any())
    assert rounded_somewhere, "the frames do not tell truncation from rounding"
    tr.instance_mask_stage()
    tr.sam_stage()
    out = np.load(os.path.join(tmp_path, "run", "stage_sam_mask", "00000", "sam_opt_mask.npy"))
    assert out.shape == (2, 2, 20, 24) and np.isfinite(out).all()


@pytest.mark.parametrize("present", [True, False])
def test_taichi01_config_reads_the_model_sam_checkpoint(tmp_path, monkeypatch, present):
    """`confs/taichi01_base.yaml` names its checkpoint under `model` only. The
    JAX entry reads the top-level key and so never builds SAM from it; the
    port's entry reads the top level, then `model.`: with the named file
    present it builds `SamSegmenter`, without it `PriorSegmenter`."""
    conf = load_config(os.path.join(os.path.dirname(CONF), "taichi01_base.yaml"))
    named = conf.model.sam_checkpoint
    assert conf.get("sam_checkpoint", None) is None and named == "outputs/sam_vit_h_4b8939.pth"
    monkeypatch.chdir(tmp_path)
    if present:
        os.makedirs("outputs")
        open(named, "wb").close()
    asked = []
    monkeypatch.setattr(sam_model, "build_sam_predictor", lambda path, device="cuda": asked.append((path, device)))
    seq = [None] * 3
    seg = cli_train.build_segmenter(conf, seq, device="cpu")
    if present:
        assert isinstance(seg, SamSegmenter) and asked == [(named, "cpu")] and len(seg.images) == len(seq)
    else:
        assert isinstance(seg, PriorSegmenter) and not asked


def test_smpl_init_loads_the_cached_network_into_every_person(tmp_path):
    """`model.smpl_init`: each person's SDF net starts as the cached
    pretrained one of its gender (no pretraining when the cache exists)."""
    from multiply_tpu_torch.engine.smpl_init import save_init
    from multiply_tpu_torch.models.networks import ImplicitNet

    _, conf, _ = build(tmp_path / "plain")
    net = ImplicitNet.from_config(conf.model.implicit_network, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    cached = {k: p.detach().clone() for k, p in net.named_parameters()}
    save_init(str(tmp_path / "cache" / "smpl_init_neutral.npz"), cached)
    tr, _, _ = build(tmp_path / "run", sets=("model.smpl_init=true", f"model.smpl_init_cache_dir={tmp_path / 'cache'}"))
    for name, param in tr.renderer.fg_implicit.named_parameters():
        for p in range(tr.num_person):
            assert torch.equal(param[p], cached[name]), (name, p)
