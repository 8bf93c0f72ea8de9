"""The port's CUDA kernels against their plain PyTorch versions, on the card;
with them the paths around the kernels on the card's machine (steps, fits,
the host builds, the JPEG decoder, ViTPose on the card against the CPU).

Marked `cuda`: they skip where there is no NVIDIA GPU (the kernels are CUDA
C++ with no CPU mode). This file imports nothing of JAX, so on a machine with
a card and no JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from multiply_tpu_torch.ops import grid_cuda, knn_cuda


def _grid_case(seed, res, n):
    rng = np.random.default_rng(seed)
    grid = rng.standard_normal((res, res, res)).astype(np.float32)
    origin = np.array([-0.6, -1.1, -0.4], np.float32)
    spacing = np.array([0.08, 0.11, 0.05], np.float32) * 16 / res
    hi = origin + spacing * (res - 1)
    pts = (origin - 0.2 * (hi - origin) + rng.random((n, 3)) * 1.4 * (hi - origin)).astype(np.float32)
    return grid, pts, origin, spacing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,v", [(2, 65536, 386), (1, 65536, 6890), (1, 1000, 7), (2, 512, 386),
                                   (1, 3001, 7171), (1, 1, 1)])
def test_nn1_kernel_matches_plain_on_card(cuda_device, p, n, v):
    gen = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((p, n, 3), generator=gen, device=cuda_device)
    r = torch.randn((p, v, 3), generator=gen, device=cuda_device)
    if v > 6:
        r[:, 5] = r[:, 2]  # an exact duplicate: the lower index must win
    launches = knn_cuda.nn1.launches
    d2_k, idx_k = knn_cuda.nn1(q, r)
    d2_e, idx_e = knn_cuda.nn1_kernel(q, r, exact=True)
    d2_p, idx_p = knn_cuda.nn1_plain(q, r)
    torch.cuda.synchronize()
    assert knn_cuda.nn1.launches == launches + 2
    assert d2_k.shape == (p, n, 1) and idx_k.shape == (p, n, 1) and idx_k.dtype == torch.int64
    # the exactly rounded build has the same tiling and selection and rounds as
    # the plain version does (no fused multiply-add): bit for bit
    assert torch.equal(d2_e, d2_p) and torch.equal(idx_e, idx_p)
    # the kernel on the path contracts the sum of squares into fused multiply-adds,
    # which moves d2 in the last bit; an index may then differ only where the two
    # candidates tie that closely, and never between exact duplicates
    assert ((d2_k - d2_p).abs() <= 1e-6 * d2_p).all() and (d2_k >= 0).all()
    assert not (idx_k == 5).any() or v <= 6
    diff = (idx_k != idx_p)[..., 0]
    if diff.any():
        chosen = torch.take_along_dim(r, idx_k.expand(p, n, 3), dim=-2)
        gap = (((q - chosen) ** 2).sum(-1) - d2_p[..., 0]).abs()
        assert (gap[diff] <= 1e-6 * d2_p[..., 0][diff]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 97, 512])
def test_grid_trilinear_kernel_matches_plain_on_card(cuda_device, group):
    """Per point (group 1) and fused with the minimum over each run of `group`
    points (97: a ray of the training step; 512: more than one stage of a warp)."""
    cases = [_grid_case(s, res=64, n=49664) for s in (5, 6)]
    args = [torch.tensor(np.stack(x), device=cuda_device) for x in zip(*cases)]
    got = grid_cuda.grid_trilinear(*args, group=group)
    want = grid_cuda.grid_trilinear_plain(*args, group=group)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 49664 // group)
    # f32 both; the kernel may contract the lerps into fused multiply-adds
    assert (got - want).abs().max().item() <= 1e-5
    # unbatched, and a point count that fills no whole warp stage
    one = [a[1, :1000] if a.dim() == 3 else a[1] for a in args]
    one[1] = one[1].contiguous()
    small = 1 if group == 1 else 8
    got = grid_cuda.grid_trilinear(*one, group=small)
    assert (got - grid_cuda.grid_trilinear_plain(*one, group=small)).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda_device):
    q = torch.zeros((8, 3), device=cuda_device)
    r = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(TypeError):
        knn_cuda.nn1(q.double(), r.double())
    with pytest.raises(ValueError):
        knn_cuda.nn1(torch.zeros((3, 8), device=cuda_device).T, r)  # not contiguous
    with pytest.raises(ValueError):
        knn_cuda.nn1(q, r.cpu())
    g = torch.zeros((4, 4, 4), device=cuda_device)
    o = torch.zeros(3, device=cuda_device)
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear(g, q[None], o, o)  # batched points, unbatched grid
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear(g.transpose(0, 2), q, o, o)  # grid not contiguous
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear(g, q, o, o, group=3)  # 3 does not divide 8 points
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear(g, q, o, o, group=0)
    launches = grid_cuda.grid_trilinear.launches
    assert grid_cuda.grid_trilinear(g, q, o, o, group=4).shape == (2,)
    assert grid_cuda.grid_trilinear.launches == launches + 1


def _small_conf():
    from multiply_tpu_torch.config import Config

    dims = [64] * 4
    return Config({
        "dim_frame_encoding": 32,
        "implicit_network": {"feature_vector_size": 256, "d_in": 3, "d_out": 1, "dims": dims,
                             "init": "geometry", "bias": 0.6, "skip_in": [2], "weight_norm": True,
                             "multires": 6, "cond": "smpl", "scene_bounding_sphere": 3.0},
        "rendering_network": {"feature_vector_size": 256, "mode": "pose_no_view", "d_in": 14,
                              "d_out": 3, "dims": [64, 64], "weight_norm": True, "multires_view": -1},
        "bg_implicit_network": {"feature_vector_size": 256, "d_in": 4, "d_out": 1, "dims": dims,
                                "init": "none", "bias": 0.0, "skip_in": [], "weight_norm": False,
                                "multires": 10, "cond": "frame"},
        "bg_rendering_network": {"feature_vector_size": 256, "mode": "nerf_frame_encoding", "d_in": 3,
                                 "d_out": 3, "dims": [128], "weight_norm": False, "multires_view": 4},
        "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
        "ray_sampler": {"near": 0.0, "eps": 0.1, "add_tiny": 1e-6, "N_samples": 16, "N_samples_eval": 32,
                        "N_samples_extra": 8, "beta_iters": 5, "max_total_iters": 3,
                        "N_samples_inverse_sphere": 8},
    })


def _step_on(dev, conf, loss_cfg, pose: bool):
    """One step's (loss, grads on the CPU, kernel launches counted) on `dev`,
    from weights and noise drawn on the CPU with fixed seeds."""
    from multiply_tpu_torch.body.params import BodyParamTable
    from multiply_tpu_torch.data.synthetic import make_scene, sample_rays
    from multiply_tpu_torch.engine.train import MODE_POSE_ONLY, Batch, PoseLossBatch, TrainStep
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    torch.backends.cuda.matmul.allow_tf32 = False
    scene = make_scene(num_frames=2, num_persons=2, height=24, width=32, device=dev)
    renderer = MultiplyRenderer(conf, 2, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)  # one CPU stream: the same draw for both devices
    noise = {k: v.to(dev) for k, v in renderer.draw_noise(64, 386, gen).items()}
    renderer = renderer.to(dev)
    state = renderer.build_person_state(scene.servers, grid_res=16)
    stepper = TrainStep(renderer, state, loss_cfg, interp_samples=256)
    transl = scene.transl.copy()
    if pose:  # person 1 steps in front of and into person 0
        transl[:, 1] = transl[:, 0] + np.array([0.1, 0.0, -0.15], np.float32)
    ts = stepper.init_state(BodyParamTable.stack([
        BodyParamTable.create(2, scene.betas[p], scene.poses[:, p, :3], transl[:, p],
                              scene.poses[:, p, 3:], device=dev) for p in range(2)]))
    ts.epoch = 30
    rays = sample_rays(scene, 1, 64, np.random.default_rng(0))
    batch = Batch(*(torch.as_tensor(x, device=dev) for x in (
        rays["uv"], rays["rgb"], scene.cam_pose[1], scene.intrinsics)), frame_idx=1,
        smpl_scale=torch.as_tensor(scene.scale, device=dev),
        sam_mask=torch.as_tensor(rays["sam"], device=dev), mode=MODE_POSE_ONLY if pose else 0)
    pose_batch = None
    if pose:  # the body meshes padded with zero vertices and degenerate 0,0,0 faces
        verts_c = torch.zeros((2, 512, 3), device=dev)
        faces = torch.zeros((2, 1024, 3), dtype=torch.int64, device=dev)
        for p, s in enumerate(scene.servers):
            verts_c[p, : len(s.verts_c)], faces[p, : len(s.model.faces)] = s.verts_c, s.model.faces
        pose_batch = PoseLossBatch(verts_c, faces, batch.uv, torch.sigmoid(batch.sam_mask), 1.5)
    if pose:
        noise["interp_idx"] = [torch.randint(0, 512, (256,), generator=gen).to(dev) for _ in range(2)]
    launches = (knn_cuda.nn1.launches, grid_cuda.grid_trilinear.launches)
    loss, logs, grads = stepper.loss_and_grads(ts, batch, noise=noise, pose_batch=pose_batch)
    counted = (knn_cuda.nn1.launches - launches[0], grid_cuda.grid_trilinear.launches - launches[1])
    logs = {k: float(v.detach()) if torch.is_tensor(v) else float(v) for k, v in logs.items()}
    return float(loss.detach()), {k: g.cpu() for k, g in grads.items()}, counted, logs


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(cuda_device):
    """The whole step through both kernels on the card against the same step
    on the CPU (plain versions), from the same weights and noise."""
    from multiply_tpu_torch.models.loss import LossConfig

    (l_cpu, g_cpu, n_cpu, _), (l_gpu, g_gpu, n_gpu, _) = (
        _step_on(dev, _small_conf(), LossConfig(sam_start_epoch=0), pose=False) for dev in ("cpu", cuda_device))
    # nn1: 2 sampler evals in round 0 + 1 per later round, render inverse, Jacobian rows
    assert n_cpu == (0, 0) and n_gpu == (_small_conf().ray_sampler.max_total_iters + 3, 1)
    # f32 on both; GEMMs and reductions sum in another order on the card
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        err = (g_cpu[k] - g_gpu[k]).abs().max().item()
        assert err <= 1e-2 * g_cpu[k].abs().max().item() + 1e-9, k


@pytest.mark.cuda
def test_pose_only_step_on_card_matches_cpu(cuda_device):
    """A pose-only step with the mesh losses on the card against the CPU:
    f32 on both, the tolerances of the joint step; one more nn1 launch for the
    deformer's forward warp of the meshes."""
    from multiply_tpu_torch.models.loss import LossConfig

    cfg = LossConfig(sam_start_epoch=0, depth_order_weight=0.1, silhouette_weight=0.05, interpenetration_weight=0.005)
    (l_cpu, g_cpu, n_cpu, logs_cpu), (l_gpu, g_gpu, n_gpu, logs_gpu) = (
        _step_on(dev, _small_conf(), cfg, pose=True) for dev in ("cpu", cuda_device))
    assert n_cpu == (0, 0) and n_gpu == (_small_conf().ray_sampler.max_total_iters + 4, 1)
    assert logs_gpu["pose_depth_order_loss"] > 0 and logs_gpu["pose_interpenetration_loss"] > 0
    for k in ("pose_depth_order_loss", "pose_silhouette_loss", "pose_interpenetration_loss"):
        assert abs(logs_cpu[k] - logs_gpu[k]) <= 1e-4 * abs(logs_cpu[k]) + 1e-7, k
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        err = (g_cpu[k] - g_gpu[k]).abs().max().item()
        assert err <= 1e-2 * g_cpu[k].abs().max().item() + 1e-9, k


@pytest.mark.cuda
def test_fast_preset_step_on_card_stays_in_a_band_around_cpu(cuda_device):
    """`sampler_bf16` + `bbox_ray_range` on the card against the CPU. The
    card's bf16 GEMMs accumulate and round at other points than the CPU's, a
    sample that moves changes every later number, so the loss is held to a
    band (5% of the CPU's loss) and the gradients to finiteness; the kernels
    still see f32 points (the wrappers raise on anything else) and are
    launched as often as in the f32 step."""
    from multiply_tpu_torch.config import Config
    from multiply_tpu_torch.models.loss import LossConfig

    conf = Config(dict(_small_conf().to_dict(), sampler_bf16=True, bbox_ray_range=True))
    (l_cpu, g_cpu, n_cpu, _), (l_gpu, g_gpu, n_gpu, _) = (
        _step_on(dev, conf, LossConfig(sam_start_epoch=0), pose=False) for dev in ("cpu", cuda_device))
    assert n_cpu == (0, 0) and n_gpu == (conf.ray_sampler.max_total_iters + 3, 1)
    assert abs(l_cpu - l_gpu) <= 0.05 * abs(l_cpu)
    assert all(torch.isfinite(g).all() and g.dtype == torch.float32 for g in g_gpu.values())
    with pytest.raises(TypeError):
        knn_cuda.nn1(torch.zeros((8, 3), device=cuda_device, dtype=torch.bfloat16),
                     torch.zeros((4, 3), device=cuda_device, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_native_build_and_generate_mesh_on_card(cuda_device):
    """The host C++ builds (through nvcc where the toolkit is) and meshes an
    SDF that the card evaluates, as the CPU does."""
    from multiply_tpu_torch import cuda_build, native
    from multiply_tpu_torch.engine.mesh_export import generate_mesh

    native._lib()
    assert os.path.exists(os.path.join(cuda_build.BUILD_DIR, "libmultiply_host.so"))
    centre = torch.tensor([0.1, -0.05, 0.02])

    def sdf_on(dev):
        c = centre.to(dev)
        return lambda pts: ((torch.as_tensor(pts, device=dev) - c).norm(dim=-1) - 0.4).cpu().numpy()

    hint = np.array([[-0.6, -0.6, -0.6], [0.6, 0.6, 0.6]], np.float32)
    v, f = generate_mesh(sdf_on(cuda_device), hint, res_up=1)
    vc, fc = generate_mesh(sdf_on("cpu"), hint, res_up=1)
    assert len(f) > 1000 and np.array_equal(f, fc)
    np.testing.assert_allclose(v, vc, atol=1e-5)
    r = np.linalg.norm(v - centre.numpy(), axis=-1)
    assert abs(np.median(r) - 0.4) < 0.01


@pytest.mark.cuda
def test_tiny_fit_on_card_crosses_epoch_0(cuda_device, tmp_path):
    """The training entry on the card at tiny widths: epoch 0's instance-mask
    and SAM stages, validation render and meshes, checkpoint; both kernels ran."""
    from multiply_tpu_torch.cli import train as cli_train

    conf = os.path.join(os.path.dirname(__file__), "..", "confs", "synthetic_base.yaml")
    sets = ("model.implicit_network.dims=[64,64]", "model.implicit_network.skip_in=[]",
            "model.cano_mesh_res_up=1", "dataset.train.end_frame=2", "model.num_training_frames=2")
    knn_cuda.nn1.launches = grid_cuda.grid_trilinear.launches = 0
    trainer = cli_train.main(["--conf", conf, "--run_dir", str(tmp_path), "--max_epochs", "1",
                              *(f"--set={s}" for s in sets)])
    assert trainer.epoch == 1 and trainer.device.type == "cuda"
    assert knn_cuda.nn1.launches > 0 and grid_cuda.grid_trilinear.launches > 0
    for rel in ("stage_instance_mask/00000/all_person_smpl_mask.npy", "stage_sam_mask/00000/sam_opt_mask.npy",
                "val/epoch_00000.png", "val/epoch_00000_person_0.ply", "checkpoints/epoch_00000",
                "checkpoints/last"):
        assert os.path.exists(os.path.join(tmp_path, rel)), rel
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        assert '"val_psnr"' in f.read()


@pytest.mark.cuda
def test_jpeg_fixtures_decode_as_opencv_on_the_card_machine(cuda_device):
    """The host decoder, built on the card's machine (nvcc as the compiler
    driver), gives the pixels that OpenCV decoded from each committed fixture."""
    import glob

    from multiply_tpu_torch.utils.io import read_png
    from multiply_tpu_torch.utils.jpeg import read_jpeg

    files = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data", "torch_jpeg", "*.jpg")))
    assert len(files) == 16
    for path in files:
        if not os.path.exists(path[:-4] + ".png"):  # a mode that OpenCV reads as None
            with pytest.raises(NotImplementedError, match="OpenCV"):
                read_jpeg(path)
            continue
        assert np.array_equal(read_jpeg(path), read_png(path[:-4] + ".png")), path


@pytest.mark.cuda
@pytest.mark.parametrize("simple", [True, False], ids=["simple", "classic"])
def test_vitpose_on_card_matches_cpu(cuda_device, tmp_path, simple):
    """A small ViTPose (hidden 64, 2 layers) with seeded weights: the card's
    heatmaps within 1e-5 of the CPU's (f32, TF32 off), and the detector's
    keypoints on a frame within 1e-2 px."""
    from multiply_tpu_torch.models.vitpose import VitPose, VitPoseConfig
    from multiply_tpu_torch.preprocessing.vitpose import VitPoseDetector

    cfg = {"backbone_config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                               "image_size": [64, 48], "out_indices": [2]},
           "use_simple_decoder": simple, "id2label": {str(i): str(i) for i in range(17)}}
    torch.manual_seed(0)
    cpu = VitPoseDetector(config=cfg, device="cpu")
    with torch.no_grad():
        for p in cpu.model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    card = VitPoseDetector(config=cfg, device=cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    x = torch.randn((3, 3, 64, 48), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = cpu.model(x), card.model(x.to(cuda_device)).cpu()
    assert isinstance(card.model, VitPose) and VitPoseConfig.from_dict(cfg).out_index == 2
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 40, 60], [60, 20, 50, 70]], np.float32)
    for a, b in zip(card(image, boxes), cpu(image, boxes)):
        np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-2, rtol=0)
        np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5 * np.abs(b[:, 2]).max(), rtol=0)
