"""The port's `Trainer` against the JAX package's, on a tiny synthetic scene.

One JAX trainer and one port trainer over the same scene arrays, parameters
and per-person state (carried across by `convert`), with the same host draws
(both trainers' `np.random.default_rng(seed)`) and, step for step, the noise
that the JAX trainer's key path drew, handed to the port through a patched
`builder.draw_noise`:
  * one `train_epoch`: every step's loss, then every parameter's change;
  * one `_opt_depth_frame` with `it_per_loop=2`: its meshes, every
    iteration's loss and the body parameters' change;
  * `convert.train_state_from_jax`: a JAX run's whole state resumes in the port.
The JAX side's K=1 search runs through direct differences, as the TPU kernel
computes it. Each parameter's change is held to JAX's within a tenth of one
Adam step (`assert_update_matches`), beside each step's gradients on both
sides (JAX's recovered from its Adam moments, the port's taken where it calls
Adam): only an entry whose two gradients part by more than a tenth is exempt.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import adam_step_grads, assert_update_matches, jax_noise, knn_direct, npify, record_adam_grads
from multiply_tpu.config import load_config as jax_load_config
from multiply_tpu.data.synthetic import make_scene as jax_make_scene
from multiply_tpu.data.synthetic_sequence import SyntheticSequence as JaxSequence
from multiply_tpu.engine import trainer as j_trainer
from multiply_tpu.engine.sam_stage import PriorSegmenter as JaxPriorSegmenter
from multiply_tpu_torch import convert
from multiply_tpu_torch.cli.train import build_servers
from multiply_tpu_torch.config import load_config
from multiply_tpu_torch.data.synthetic import SyntheticScene
from multiply_tpu_torch.data.synthetic_sequence import SyntheticSequence
from multiply_tpu_torch.engine import train as t_train
from multiply_tpu_torch.engine import trainer as t_trainer
from multiply_tpu_torch.engine.sam_stage import PriorSegmenter

CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "confs", "synthetic_base.yaml")
OVERRIDES = {
    "model": {
        "learning_rate": 1.0e-5,
        "implicit_network": {"dims": [32, 32], "skip_in": [], "multires": 2, "feature_vector_size": 32},
        "rendering_network": {"dims": [32], "feature_vector_size": 32},
        "bg_implicit_network": {"dims": [32, 32], "multires": 2, "feature_vector_size": 32},
        "bg_rendering_network": {"dims": [16], "feature_vector_size": 32},
        "ray_sampler": {"N_samples": 8, "N_samples_eval": 16, "N_samples_extra": 4, "beta_iters": 3,
                        "max_total_iters": 2, "N_samples_inverse_sphere": 4},
        "dim_frame_encoding": 8,
        "depth_epoch": [20],
        "it_per_loop": 2,
        "depth_render_rays": 32,
        "depth_pixel_samples": 96,
        "interp_samples": 48,
        "mesh_pad_bucket": 1024,
        "num_training_frames": 2,
        "cano_grid_res": 8,
        "cano_mesh_res_up": 0,
    },
    "dataset": {"train": {"num_sample": 40, "end_frame": 2, "height": 20, "width": 24}},
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX trainer, port trainer) sharing a run directory, with the JAX
    parameters and per-person state carried into the port."""
    from train import build_servers as jax_build_servers

    with pytest.MonkeyPatch.context() as mp:
        import multiply_tpu.ops.knn_pallas as kp

        mp.setattr(kp, "knn_auto", knn_direct)
        run_dir = str(tmp_path_factory.mktemp("run"))
        jconf = jax_load_config(CONF_PATH, overrides=OVERRIDES)
        scene = jax_make_scene(num_frames=2, num_persons=2, height=20, width=24)
        jseq = JaxSequence(scene, num_sample=40, run_dir=run_dir)
        jtr = j_trainer.Trainer(jconf, jseq, jax_build_servers(jconf, jseq), run_dir=run_dir,
                                segmenter=JaxPriorSegmenter())

        conf = load_config(CONF_PATH, overrides=OVERRIDES)
        arrays = {f: getattr(scene, f) for f in SyntheticScene._fields if f != "servers"}
        tscene = SyntheticScene(servers=[], **arrays)
        seq = SyntheticSequence(tscene, num_sample=40, run_dir=run_dir)
        tr = t_trainer.Trainer(conf, seq, build_servers(conf, seq, "cpu"), run_dir=run_dir,
                               segmenter=PriorSegmenter(), device="cpu")
        # jitter the initial weights, so that no leaf starts at zero or stays silent
        rng = np.random.default_rng(11)
        net = jax.tree.map(lambda a: a + 0.03 * rng.standard_normal(a.shape).astype(np.float32),
                           npify(jtr.ts.params["net"]))
        jtr.ts = jtr.ts._replace(params={"net": jax.tree.map(jax.numpy.asarray, net), "body": jtr.ts.params["body"]})
        sync(jtr, tr)
        tr.person_state = convert.person_state_from_jax(npify(jtr.person_state), device="cpu")
        tr.builder.state = tr.person_state
        yield jtr, tr


def sync(jtr, tr):
    convert.load_params(tr.ts.params(), npify(jtr.ts.params))


def record_steps(jtr, tr, mp):
    """Record each step's logs and gradients on both sides (JAX's from its Adam
    moments); hand the port the noise of the JAX trainer's key path for the
    coming epoch. Returns (JAX logs, port logs, JAX gradients, port gradients)."""
    keys = list(jax.random.split(jtr.key, tr.num_frames + 1)[1:])
    jlogs, logs, jgrads, pgrads = [], [], [], []
    calls = record_adam_grads(mp, t_train)
    jstep, step = jtr._step, tr.builder.step
    names = list(tr.ts.params())

    def jax_recorded(ts, *args):
        before = npify(ts)  # the step donates `ts`
        ts, out = jstep(ts, *args)
        after = npify(ts)
        jgrads.append(adam_step_grads(names, [(before.opt_joint, after.opt_joint), (before.opt_pose, after.opt_pose)]))
        jlogs.append(npify(out))
        return ts, out

    def recorded(*args, **kw):
        first = len(calls)
        ts, out = step(*args, **kw)
        logs.append({k: float(v) for k, v in out.items()})
        grads = {}  # a step calls Adam once per optimizer
        for call in calls[first:]:
            for k, g in call.items():
                grads[k] = grads.get(k, 0.0) + g
        pgrads.append(grads)
        return ts, out

    def draw_noise(batch, pose_batch=None, generator=None):
        return jax_noise(keys.pop(0), jtr.renderer, batch.uv.shape[0], tr.person_state.server.verts_c.shape[1])

    mp.setattr(jtr, "_step", jax_recorded)
    mp.setattr(tr.builder, "step", recorded)
    mp.setattr(tr.builder, "draw_noise", draw_noise)
    return jlogs, logs, jgrads, pgrads


def assert_updates_match(tr, jtr, before, jgrads, pgrads, body_factor=0.1):
    """Every port parameter's change from `before` (JAX's parameters, which
    the port started from) against JAX's, over the steps whose gradients
    `jgrads` and `pgrads` hold (one dict per step, by the names to compare).
    The entries exempt for their unresolved gradients must be at most 1% of
    those compared."""
    jparams = npify(jtr.ts.params)
    exempt, entries, lr = 0, 0, tr.builder.lr
    for name, p in tr.ts.params().items():
        if name not in jgrads[0]:
            continue
        step = lr * (body_factor if name.startswith("body.") else 1.0)
        entries += p.numel()
        exempt += assert_update_matches(name, convert.flax_leaf(before, name), convert.to_flax_layout(name, p),
                                        convert.flax_leaf(jparams, name), [g[name] for g in jgrads],
                                        [g[name] for g in pgrads], step)
    assert exempt <= 0.01 * entries, f"{exempt} of {entries} entries exempt"
    worst = max(np.abs(np.asarray(p[k]) - j[k]).max() / max(np.abs(j[k]).max(), 1e-30)
                for j, p in zip(jgrads, pgrads) for k in j)
    print(f"{exempt} of {entries} entries exempt for their unresolved gradients; the gradients part by at most "
          f"{worst:.3g} of a leaf's largest")


def test_train_epoch_matches_jax(pair):
    jtr, tr = pair
    sync(jtr, tr)
    before = npify(jtr.ts.params)
    with pytest.MonkeyPatch.context() as mp:
        import multiply_tpu.ops.knn_pallas as kp

        mp.setattr(kp, "knn_auto", knn_direct)
        jlogs, logs, jgrads, pgrads = record_steps(jtr, tr, mp)
        jout = jtr.train_epoch()
        out = tr.train_epoch()
    assert len(logs) == len(jlogs) == tr.num_frames
    for i, (got, want) in enumerate(zip(logs, jlogs)):
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-4, err_msg=f"step {i}")
        assert got["update_skipped"] == 0.0
    for k in ("n_joint", "n_pose_only", "n_delayed_pose"):
        assert out[k] == jout[k], k
    assert_updates_match(tr, jtr, before, jgrads, pgrads)


def test_opt_depth_frame_matches_jax(pair, monkeypatch):
    import multiply_tpu.ops.knn_pallas as kp

    monkeypatch.setattr(kp, "knn_auto", knn_direct)
    jtr, tr = pair
    jtr.instance_mask_stage()
    jtr.sam_stage()
    jtr.seq._refresh_sam()
    tr.seq._refresh_sam()
    sync(jtr, tr)

    # the meshes each side extracts, and the JAX loop's per-iteration key and loss
    meshes = {"jax": [], "port": []}
    for side, module in (("jax", j_trainer), ("port", t_trainer)):
        original = module.generate_mesh

        def recorded(*args, side=side, original=original, **kw):
            out = original(*args, **kw)
            meshes[side].append(out)
            return out

        monkeypatch.setattr(module, "generate_mesh", recorded)
    key, ks = jtr.key, []
    for _ in range(tr.it_per_loop):
        key, k = jax.random.split(key)
        ks.append(k)
    jvals, vals, jgrads = [], [], []
    jgrad = jtr._depth_grad_fn()
    body_names = [k for k in tr.ts.params() if k.startswith("body.")]

    def as_tree(state):  # the body's Adam state, under the name the port's leaves carry
        return state._replace(mu={"body": state.mu}, count={"body": state.count})

    def jax_recorded(*args):
        out = jgrad(*args)
        jvals.append(float(out[2]))
        jgrads.append(adam_step_grads(body_names, [(as_tree(npify(args[1])), as_tree(npify(out[1])))]))
        return out

    jtr._depth_grad = jax_recorded

    def draw_noise(batch, pose_batch=None, generator=None):
        k = ks.pop(0)
        noise = jax_noise(jax.random.fold_in(k, 3), jtr.renderer, batch.uv.shape[0],
                          tr.person_state.server.verts_c.shape[1])
        V = pose_batch.verts_c.shape[1]
        noise["interp_idx"] = [
            torch.tensor(np.asarray(jax.random.randint(jax.random.fold_in(k, p), (min(tr.interp_samples, V),), 0, V)))
            for p in range(tr.num_person)
        ]
        return noise

    monkeypatch.setattr(tr.builder, "draw_noise", draw_noise)
    depth_loss = tr._depth_loss

    def recorded_loss(*args, **kw):
        val, parts = depth_loss(*args, **kw)
        vals.append(float(val.detach()))
        return val, parts

    monkeypatch.setattr(tr, "_depth_loss", recorded_loss)
    pgrads = record_adam_grads(monkeypatch, t_trainer, prefix="body.")
    before = npify(jtr.ts.params)
    net_before = {k: p.detach().clone() for k, p in tr.ts.params().items() if k not in body_names}
    jtr._opt_depth_frame(0)
    tr._opt_depth_frame(0)

    assert len(meshes["port"]) == len(meshes["jax"]) == tr.num_person
    for (v, f), (jv, jf) in zip(meshes["port"], meshes["jax"]):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_allclose(v, jv, atol=1e-5)
    assert len(vals) == len(jvals) == tr.it_per_loop
    np.testing.assert_allclose(vals, jvals, rtol=1e-4)
    # the body moves by opt_depth's own Adam (no body factor); the net stays
    assert len(pgrads) == len(jgrads) == tr.it_per_loop
    assert_updates_match(tr, jtr, before, jgrads, pgrads, body_factor=1.0)
    assert all(torch.equal(p, net_before[k]) for k, p in tr.ts.params().items() if k in net_before)
    for stage in ("front", "gt"):
        for it in (0, tr.it_per_loop - 1):
            assert os.path.exists(os.path.join(tr.run_dir, "stage_depth_map", "00000", f"{it:05d}", stage,
                                               f"{stage}_0000.png"))


def test_jax_train_state_resumes_in_the_port(pair):
    """After a JAX epoch, its whole state (parameters, Adam moments and
    counts, epoch) carried into the port: one more epoch on each side agrees."""
    jtr, tr = pair
    with pytest.MonkeyPatch.context() as mp:
        import multiply_tpu.ops.knn_pallas as kp

        mp.setattr(kp, "knn_auto", knn_direct)
        jtr.epoch = tr.epoch = 3
        jtr.train_epoch()
        convert.train_state_from_jax(tr.ts, npify(jtr.ts))
        tr.rng.bit_generator.state = jtr.rng.bit_generator.state  # the host draws resume too
        jts = npify(jtr.ts)
        assert tr.ts.epoch == 3
        for name in tr.ts.params():
            np.testing.assert_array_equal(convert.to_flax_layout(name, tr.ts.opt_joint.mu[name]),
                                          convert.flax_leaf(jts.opt_joint.mu, name))
            assert tr.ts.opt_joint.count[name] == int(convert.flax_leaf(jts.opt_joint.count, name))
        assert max(tr.ts.opt_joint.count.values()) > 0
        before = jts.params
        jlogs, logs, jgrads, pgrads = record_steps(jtr, tr, mp)
        jtr.epoch = tr.epoch = 4
        jtr.train_epoch()
        tr.train_epoch()
    for got, want in zip(logs, jlogs):
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-4)
    assert_updates_match(tr, jtr, before, jgrads, pgrads)
