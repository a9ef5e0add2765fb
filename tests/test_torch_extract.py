"""The port's mesh extraction (`extract.py`, `ops/coord.contract` /
`inv_contract`, `ZipMLP.predict_density`, the `extract` CLI) against the
JAX package at `tiny_debug` shapes, with the same weights (every hash
table uniform(-0.5, 0.5), so that the density varies over the lattice),
plain versions on the CPU, TF32 off.

Tolerances: contract / inv_contract rtol 1e-6; predict_density and the
density lattice rtol 1e-5 / atol 1e-6; auto_normals exactly; vertex
colours atol 1e-5; the visibility grid exactly. A mesh is built from one
lattice (a lattice value within rounding of the level can add or drop a
vertex between the packages), so the port's mesh pipeline is handed the
JAX lattice: its PLY then has the JAX file's header, faces and vertex
lines, and colours within one level of 255 (they come from the colours'
atol 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu import extract as jextract
from nerf_lidar_tpu import native as jnative
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.ops import coord as jcoord
from nerf_lidar_tpu.train import checkpoints as jcheckpoints
from nerf_lidar_tpu.train import train_step as jtrain_step
from nerf_lidar_tpu_torch import cli, configs, convert, extract
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.ops import coord

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
RES = 16


@pytest.fixture(scope="module")
def field():
    """(JAX model, JAX params, port model, JAX lattice at RES, the level: the
    lattice's 70th percentile)."""
    jcfg = jconfigs.tiny_debug()
    jmodel = JaxModel(jcfg.model)
    probe = {k: jnp.asarray(v) for k, v in jcli._probe_batch(
        jcli.load_scene_for(jcfg, "train").data).items()}
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), None, probe))
    rng = np.random.RandomState(1)
    for sub in params["params"].values():
        sub["table"] = rng.uniform(-0.5, 0.5, sub["table"].shape).astype(
            np.float32)
    cfg = configs.tiny_debug()
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    grid, _ = jextract.density_on_lattice(jmodel, params, RES)
    return jmodel, params, model.eval(), grid, float(np.percentile(grid, 70))


def _decimate_target(grid, level):
    """A face count 100 below the cleaned mesh's: 50 edge collapses of
    quadric decimation (each takes milliseconds in Python)."""
    from nerf_lidar_tpu.utils import marching as jmarching
    verts, faces = _mesh(grid, level)
    return len(jmarching.clean_mesh(verts, faces)[1]) - 100


def _points(n=500, seed=0):
    """Points inside, on and outside the unit ball, and near the origin."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3) * np.exp(rng.uniform(-6, 3, (n, 1)))
    x[:4] = [[0, 0, 0], [1, 0, 0], [0, 0.6, 0.8], [1e-6, 0, 0]]
    return x.astype(np.float32)


def test_contract_and_inv_contract_match_jax():
    x = _points()
    for fn, jfn, pts in ((coord.contract, jcoord.contract, x),
                         (coord.inv_contract, jcoord.inv_contract,
                          np.clip(x, -1.99, 1.99) / 1.8)):
        got = fn(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(pts))),
                                   rtol=1e-6, atol=0)
    z = np.asarray(jcoord.contract(jnp.asarray(x)))
    np.testing.assert_allclose(
        coord.inv_contract(torch.from_numpy(z)).numpy(), x, rtol=2e-3,
        atol=1e-6)


@pytest.mark.parametrize("level", ["nerf", "prop"])
def test_predict_density_matches_jax(field, level):
    """(raw density, bottleneck) of the density trunk at n = 7 multisamples
    with stds, and at n = 1 with stds 0 (the lattice's call)."""
    jmodel, params, model, _, _ = field
    rng = np.random.RandomState(2)
    for n, scale in ((7, 0.02), (1, 0.0)):
        means = rng.uniform(-3, 3, (64, 4, n, 3)).astype(np.float32)
        stds = (rng.uniform(0, 1, (64, 4, n)) * scale).astype(np.float32)
        mlp = model.nerf_mlp if level == "nerf" else model.prop_mlps[0]
        with torch.no_grad():
            raw, x = mlp.predict_density(torch.from_numpy(means),
                                         torch.from_numpy(stds))
        want = jmodel.apply(params, jnp.asarray(means), jnp.asarray(stds),
                            method=lambda m, mm, ss: (
                                m.nerf_mlp if level == "nerf"
                                else m.prop_mlps[0]).predict_density(mm, ss))
        assert raw.shape == (64, 4) and x.shape[:2] == (64, 4)
        np.testing.assert_allclose(raw.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


def test_density_on_lattice_matches_jax(field):
    _, _, model, want, _ = field
    got, pts = extract.density_on_lattice(model, RES, chunk=1000)
    _, want_pts = jextract.density_on_lattice(field[0], field[1], 4)
    assert got.shape == (RES,) * 3 and pts.shape == (RES,) * 3 + (3,)
    assert float(want.std()) > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(extract.density_on_lattice(model, 4)[1],
                                  want_pts)


def _mesh(grid, level):
    from nerf_lidar_tpu.utils import marching as jmarching
    verts, faces = jmarching.weld_vertices(*jmarching.marching_tetrahedra(
        grid, level, origin=(-1.0,) * 3, spacing=(2.0 / (RES - 1),) * 3))
    return verts.astype(np.float32), faces


def test_normals_and_vertex_colours_match_jax(field):
    jmodel, params, model, grid, level = field
    verts, faces = _mesh(grid, level)
    assert len(faces) > 100
    np.testing.assert_array_equal(extract.auto_normals(verts, faces),
                                  jextract.auto_normals(verts, faces))
    got = extract.rgb_by_projection(model, verts, faces, chunk=300)
    want = jextract.rgb_by_projection(jmodel, params, verts, faces,
                                      chunk=300)
    assert got.shape == (len(verts), 3) and float(got.std()) > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = extract.rgb_at_points(model, verts, chunk=300)
    want = jextract.rgb_at_points(jmodel, params, verts, chunk=300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_visibility_grid_equals_jax(field):
    jmodel, params, model, _, _ = field
    data = jcli.load_scene_for(jconfigs.tiny_debug(), "train").data
    kw = dict(resolution=12, pixel_stride=6, chunk=64, weight_thresh=0.05)
    got = extract.build_visibility_grid(model, data, **kw)
    want = jextract.build_visibility_grid(jmodel, params, data, **kw)
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(extract._sample_mask(got, RES),
                                  jextract._sample_mask(got, RES))


def _read_ply(path):
    """(header lines, vertex lines split into (xyz text, rgb ints), face
    lines)."""
    lines = open(path).read().splitlines()
    end = lines.index("end_header") + 1
    head = lines[:end]
    n_v = int(next(h for h in head if "element vertex" in h).split()[-1])
    verts = [ln.split() for ln in lines[end:end + n_v]]
    return (head, [v[:3] for v in verts],
            np.array([[int(c) for c in v[3:]] for v in verts]),
            lines[end + n_v:])


def assert_same_ply(got, want):
    g, w = _read_ply(got), _read_ply(want)
    assert g[0] == w[0] and g[1] == w[1] and g[3] == w[3]
    assert len(g[1]) > 0 and len(g[3]) > 0
    if g[2].size:
        assert np.abs(g[2] - w[2]).max() <= 1


@pytest.mark.parametrize("kw", [
    dict(), dict(clean=True), dict(clean=True, decimate_target=-1),
    dict(vertex_color=False), dict(color_mode="points")])
def test_extract_mesh_from_one_lattice_equals_jax(field, tmp_path,
                                                  monkeypatch, kw):
    """extract_mesh of both packages from the JAX lattice (the port's
    `density_on_lattice` hands it over): the same PLY, and the same arrays
    (colours at atol 1e-5)."""
    jmodel, params, model, grid, level = field
    monkeypatch.setattr(jnative, "mesh_available", lambda: False)
    monkeypatch.setattr(extract, "density_on_lattice",
                        lambda *a, **k: (grid, None))
    if kw.get("decimate_target"):
        kw = dict(kw, decimate_target=_decimate_target(grid, level))
    args = dict(resolution=RES, isosurface_threshold=level, **kw)
    got = extract.extract_mesh(model, out_path=str(tmp_path / "p.ply"),
                               **args)
    want = jextract.extract_mesh(jmodel, params,
                                 out_path=str(tmp_path / "j.ply"), **args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None)
    if want[2] is not None:
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert_same_ply(tmp_path / "p.ply", tmp_path / "j.ply")


def test_extract_cli_equals_jax(field, tmp_path, monkeypatch):
    """`extract --resolution RES --threshold <level> --clean --decimate N`
    of both CLIs on one JAX checkpoint_3.ckpt, the port handed the JAX
    lattice: the same mesh.ply; the port's own lattice gives the JAX
    lattice at the lattice tolerance; and an empty mesh (threshold above
    every value) comes back empty, without colours."""
    jmodel, params, model, grid, level = field
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jnative, "mesh_available", lambda: False)
    jcfg = jconfigs.tiny_debug()
    for name in ("j", "p"):
        jcheckpoints.save_checkpoint(
            f"exp/{name}", jtrain_step.create_train_state(jcfg, params)[0], 3)
    base = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
            "--resolution", str(RES)]
    target = _decimate_target(grid, level)
    args = [*base, "--threshold", str(level), "--clean", "--decimate",
            str(target)]
    jcli.main(["extract", *args, "--exp_name", "j"])
    lattices = []
    orig = extract.density_on_lattice

    def jax_lattice(*a, **k):
        lattices.append(orig(*a, **k)[0])
        return grid, None

    monkeypatch.setattr(extract, "density_on_lattice", jax_lattice)
    run = cli.main(["extract", *args, "--exp_name", "p", "--device", "cpu"])
    assert run.path == os.path.join("exp", "p", "mesh.ply")
    assert not run.model.has_objects and len(run.faces) <= target
    assert_same_ply(run.path, "exp/j/mesh.ply")
    np.testing.assert_allclose(lattices[0], grid, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(extract, "density_on_lattice", orig)
    top = ["--threshold", str(float(grid.max()) + 1), "--exp_name"]
    jcli.main(["extract", *base, *top, "j"])
    empty = cli.main(["extract", *base, *top, "p", "--device", "cpu"])
    assert len(empty.verts) == 0 and empty.colors is None
    with pytest.raises(SystemExit, match="no checkpoint in exp/none"):
        cli.main(["extract", *args, "--exp_name", "none", "--device", "cpu"])
