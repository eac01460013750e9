"""The port's checkpoints with PartitionSpecs (``repro_torch.checkpoint``'s
``save_pytree(specs=)``, ``restore_pytree(mesh=, specs=)``,
``CheckpointManager``) against the JAX package's on the CPU:

  * a manifest with specs is byte-equal to the reference's
    ``save_pytree(specs=...)`` of the same tree (a reduced model's
    ``TrainState`` under ``param_specs``), the arrays equal;
  * elastic restart (``tests/test_checkpoint.py:178``): saved from a 4 × 2
    mesh, restored onto 2 × 4, 8 × 1 and 1 × 1 meshes of ``"cpu"``
    positions, equal, each leaf placed by its spec on the new mesh;
  * a directory the reference saved restores through the port onto a mesh,
    and one the port saved from a mesh restores in the reference.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.checkpoint import restore_pytree as jrestore  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamWState as JAdamW  # noqa: E402
from repro.train import TrainState as JTrainState  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.pytree import tree_leaves  # noqa: E402
from repro_torch.sharding import P  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)


def cpu_mesh(shape):
    return make_mesh_auto(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def states(arch="deepseek-moe-16b"):
    """The reference's TrainState and specs at tp 2, and the port's."""
    jcfg = jmodel.get_config(arch).reduced().padded(2)
    tcfg = tmodel.get_config(arch).reduced().padded(2)
    js = jstep.train_state_init(jax.random.PRNGKey(1), jcfg)
    ts = tstep.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jp = jsh.param_specs(jcfg, js.params, 2)
    tp = tsh.param_specs(tcfg, ts.params, 2)
    return (js, JTrainState(params=jp, opt=JAdamW(step=JP(), m=jp, v=jp)),
            ts, TrainState(params=tp, opt=AdamWState(step=P(), m=tp, v=tp)))


def assert_same_arrays(a, b):
    with np.load(a / "arrays.npz") as x, np.load(b / "arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b", "musicgen-medium"])
def test_manifest_with_specs_byte_equal_to_reference(tmp_path, arch):
    js, jspecs, ts, tspecs = states(arch)
    jsave(tmp_path / "ref", js, specs=jspecs, extra={"data_step": 7})
    placed = tsh.place(ts, tspecs, cpu_mesh((4, 2)))  # saved from the mesh, gathered
    save_pytree(tmp_path / "port", placed, specs=tspecs, extra={"data_step": 7})
    want = (tmp_path / "ref" / "manifest.json").read_bytes()
    assert (tmp_path / "port" / "manifest.json").read_bytes() == want
    assert "PartitionSpec(None, 'model', None)" in json.loads(want)["specs"]
    assert_same_arrays(tmp_path / "port", tmp_path / "ref")


def test_elastic_restore_onto_other_meshes(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    specs = {"w": P("data", "model")}
    sharded = tsh.place(tree, specs, cpu_mesh((4, 2)))
    save_pytree(tmp_path / "ck", sharded, specs=specs, extra={})
    for shape in ((2, 4), (8, 1), (1, 1)):
        mesh = cpu_mesh(shape)
        restored, _ = restore_pytree(tmp_path / "ck", tree, mesh=mesh, specs=specs)
        w = restored["w"]
        assert isinstance(w, tsh.Placed) and w.mesh is mesh and w.spec == specs["w"]
        assert w.mesh.shape["data"] == shape[0] and len(w.blocks) == shape[0] * shape[1]
        assert torch.equal(w.tensor(), tree["w"])


def test_reference_checkpoint_restores_onto_a_mesh_and_back(tmp_path):
    js, jspecs, ts, tspecs = states()
    jsave(tmp_path / "ref", js, specs=jspecs, extra={"data_step": 3})
    mesh = cpu_mesh((2, 4))
    like = tsh.place(ts, tspecs, cpu_mesh((4, 2)))
    restored, extra = restore_pytree(tmp_path / "ref", like, mesh=mesh, specs=tspecs)
    assert extra == {"data_step": 3}
    for got, want in zip(tree_leaves(restored), jax.tree.leaves(js)):
        assert got.mesh is mesh
        assert np.array_equal(got.tensor().numpy(), np.asarray(want))
    save_pytree(tmp_path / "port", restored, specs=tspecs, extra=extra)
    back, extra = jrestore(tmp_path / "port", js)
    assert extra == {"data_step": 3}
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_manager_saves_specs_and_restores_onto_a_mesh(tmp_path):
    _, _, ts, tspecs = states("musicgen-medium")
    mesh = cpu_mesh((4, 2))
    placed = tsh.place(ts, tspecs, mesh)
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, placed, specs=tspecs, extra={"data_step": 5})
    mgr.wait()
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["specs"] == [repr(s) for s in tree_leaves(tspecs)]
    step, restored, extra = mgr.restore_latest(ts, mesh=cpu_mesh((8, 1)), specs=tspecs)
    assert step == 4 and extra == {"data_step": 5}
    for got, want in zip(tree_leaves(restored), tree_leaves(ts)):
        assert torch.equal(got.tensor(), want)
