"""The port's sharding rules and meshes (``repro_torch.sharding``,
``repro_torch.launch.mesh``, ``launch/steps.py``'s ``fsdp_param_specs``)
against the JAX package's, on the CPU.

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, so the
reference's run on a duck-typed 4 × 2 and 2 × 16 × 16 mesh: for every
registry architecture's ``reduced()`` parameters (``padded(tp)``, as
``build_cell`` lays them out) and decode caches at tp 1, 2 and 4, each leaf's
``PartitionSpec`` is the port's ``P`` entry for entry and by ``repr``
(checkpoints store the ``repr``).  Then the port alone: placement and
gathering on a 4 × 2 mesh of ``"cpu"`` positions (blocks shared by
positions on one device, JAX's divisibility error), the collectives'
counts, ``constrain``'s checks against JAX's ``with_sharding_constraint``
(unknown axis, rank, no mesh, and an axis that does not divide a dimension,
which GSPMD pads and both accept), and the mesh builders.
"""

import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.pytree import flatten_with_names  # noqa: E402
from repro_torch.sharding import P  # noqa: E402

torch.set_num_threads(1)

ARCHS = jmodel.list_archs()
MESHES = {
    "4x2": types.SimpleNamespace(shape={"data": 4, "model": 2}, axis_names=("data", "model")),
    "2x16x16": types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                     axis_names=("pod", "data", "model")),
}


def ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), s) for p, s in flat]


def assert_same_specs(got, want):
    got, want = flatten_with_names(got), ref_leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert isinstance(g, P), name
        assert tuple(g) == tuple(w) and repr(g) == repr(w), (name, g, w)


def both_configs(arch, tp):
    return (jmodel.get_config(arch).reduced().padded(tp),
            tmodel.get_config(arch).reduced().padded(tp))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, tp):
    jcfg, tcfg = both_configs(arch, tp)
    jparams = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = tmodel.abstract_params(tcfg)
    assert_same_specs(tsh.param_specs(tcfg, tparams, tp), jsh.param_specs(jcfg, jparams, tp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = both_configs(arch, m.shape["model"])
    for batch in (1, 8, 64):  # short of the data axes, filling 4, filling 32
        jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, batch, 32))
        tcache = ttf.init_cache(tcfg, batch, 32, device="meta")
        assert_same_specs(tsh.cache_specs(tcfg, tcache, m, batch),
                          jsh.cache_specs(jcfg, jcache, m, batch))
    inputs = {"tokens": np.zeros((8, 16), np.int32), "pos": np.zeros((), np.int32),
              "prefix_embeds": np.zeros((8, 4, 16), np.float32)}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    assert_same_specs(tsh.input_specs_sharding(m, tin), jsh.input_specs_sharding(m, inputs))
    assert tsh.data_axes(m) == jsh.data_axes(m)
    assert repr(tsh.batch_spec(m)) == repr(jsh.batch_spec(m))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b", "paligemma-3b"])
def test_fsdp_param_specs_match_reference(arch, mesh):
    jcfg, tcfg = both_configs(arch, 1)
    jparams = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    got = tsteps.fsdp_param_specs(tmodel.abstract_params(tcfg), MESHES[mesh])
    assert_same_specs(got, jsteps.fsdp_param_specs(jparams, MESHES[mesh]))


@pytest.mark.parametrize("parts", [
    (), (None,), ("data",), (("data",),), ((),), ("data", None), (("pod", "data"), "model", None),
    (None, None, "model"), (["data", "model"],), ("model", ("data",), None),
])
def test_partition_spec_repr_and_entries(parts):
    assert repr(P(*parts)) == repr(JP(*parts))
    assert tuple(P(*parts)) == tuple(JP(*parts))
    assert P(*parts) == P(*parts) and hash(P(*parts)) == hash(P(*parts))


def cpu_mesh(shape=(4, 2)):
    return tmesh.make_mesh_auto(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("spec,blocks", [
    (P("data", "model"), 8), (P("model", None), 2), (P(None, "data"), 4),
    (P(("data", "model"), None), 8), (P(), 1), (P(None, ("model", "data")), 8),
])
def test_place_and_gather_round_trip(spec, blocks):
    mesh = cpu_mesh()
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    p = tsh.place_tensor(x, spec, mesh)
    assert len(p.blocks) == blocks  # one per distinct block index on the one device
    for pos in mesh.positions():  # each position's block is its slice
        coords = dict(zip(mesh.axis_names, pos))
        want = x
        for d, entry in enumerate(spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            n, i = 1, 0
            for a in axes:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
            step = x.shape[d] // n
            want = want.narrow(d, i * step, step)
        assert torch.equal(p.block_at(pos), want)
    tsh.reset_collectives()
    assert torch.equal(tsh.gather_tensor(p), x)
    counts = tsh.collective_counts()
    if blocks == 1:  # a replicated tensor is its block: nothing moves
        assert counts == {} and tsh.gather_tensor(p) is x
    else:
        assert counts == {"all-gather": {"count": 1, "bytes": x.numel() * 4}}


def test_placement_refuses_what_jax_refuses():
    mesh = cpu_mesh()
    with pytest.raises(ValueError, match="does not evenly divide the dimension size 6"):
        tsh.place_tensor(torch.zeros(6, 3), P("data", None), mesh)
    with pytest.raises(ValueError, match="not found in mesh"):
        tsh.place_tensor(torch.zeros(8, 3), P("nope", None), mesh)
    with pytest.raises(ValueError, match="entries for a rank-2"):
        tsh.place_tensor(torch.zeros(8, 2), P("data", None, None), mesh)
    with pytest.raises(ValueError, match="twice"):
        tsh.place_tensor(torch.zeros(8, 8), P("data", "data"), mesh)


def test_constrain_checks_as_with_sharding_constraint():
    x = torch.zeros(6, 3)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        tsh.constrain(x, P("data", None))
    mesh = cpu_mesh()
    with mesh:
        assert tsh.current_mesh() is mesh
        assert tsh.constrain(x, P("data", None)) is x  # GSPMD pads: 6 over 4 is accepted
        with pytest.raises(ValueError, match="not found in mesh"):
            tsh.constrain(x, P("nope", None))
        with pytest.raises(ValueError, match="entries for a rank-2"):
            tsh.constrain(x, P("data", None, None))
        with pytest.raises(TypeError, match="PartitionSpec"):
            tsh.constrain(x, ("data", None))
    assert tmesh.current_mesh() is None


def test_jitted_donates_and_places_outputs():
    mesh = cpu_mesh()
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    state = {"w": w.clone(), "n": torch.zeros((), dtype=torch.int32)}
    specs = {"w": P("data", "model"), "n": P()}

    def step(st, x):
        st["w"].add_(x.sum())  # in place, as the train step writes its state
        return {"w": st["w"], "n": st["n"] + 1}, st["w"].sum(0)

    f = tsh.Jitted(step, mesh, (specs, P("data")), out_specs=(specs, P("model")),
                   donate_argnums=(0,))
    placed = tsh.place(state, specs, mesh)
    blocks = {k: dict(v.blocks) for k, v in placed.items()}
    tsh.reset_collectives()
    out, col = f(placed, torch.ones(8))
    assert out["w"] is placed["w"] and out["n"] is placed["n"]  # the donated tree
    for k in blocks:  # written in place, block for block
        assert all(out[k].blocks[b] is t for b, t in blocks[k].items())
    assert torch.equal(out["w"].tensor(), w + 8) and int(out["n"]) == 1
    assert isinstance(col, tsh.Placed) and col.spec == P("model")
    assert torch.equal(col.tensor(), (w + 8).sum(0))
    counts = tsh.collective_counts()
    assert counts["all-gather"]["bytes"] == 32 * 4 + 8 * 4  # w and the batch
    assert counts["reduce-scatter"]["bytes"] == 32 * 4 + 4 * 4  # w's blocks, col's halves
    assert "all-reduce" not in counts  # n stays on the first device
    assert f.last_memory == {"argument_size_in_bytes": 4 * 4 + 4 + 2 * 4,
                             "output_size_in_bytes": 4 * 4 + 4 + 2 * 4,
                             "alias_size_in_bytes": 4 * 4 + 4}


def test_mesh_builders():
    m = tmesh.make_production_mesh(devices=["meta"] * 256)
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert m.devices.shape == (16, 16)
    m = tmesh.make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert m.axis_names == ("pod", "data", "model") and m.devices.size == 512
    # the reference's rule: more positions than devices becomes (n, 1)
    h = tmesh.make_host_mesh(4, 2, "cpu")
    assert h.shape == {"data": 1, "model": 1} and str(h.first_device) == "cpu"
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_mesh_auto((4, 2), ("data", "model"), ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 8 CUDA devices"):
            tmesh.make_mesh_auto((4, 2), ("data", "model"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh(1, 1)
