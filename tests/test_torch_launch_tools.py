"""The port's roofline and dry-run tools (``repro_torch.launch.roofline``,
``repro_torch.launch.dryrun``) on the CPU:

  * ``analytic_params`` (total and active) and ``model_flops`` equal to the
    reference's for every registry architecture × shape;
  * ``analyze_cell`` and ``render_table`` equal to the reference's on
    synthetic dry-run JSONs under the reference's constants, and the
    port's null fields (no ``bytes accessed``, no temp size) handled;
  * the dry run of tiny cells on a 4 × 2 mesh of meta positions records
    every field, its depth-1/depth-2 reconstruction equals the direct
    count, and its FLOPs equal ``FlopCounterMode``'s count of the
    single-device step.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch import roofline as jroof  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.models import config as tmc  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

ARCHS = jmodel.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_params_and_model_flops_match_reference(arch):
    assert tmodel.list_archs() == ARCHS and list(tmc.SHAPES) == list(jmc.SHAPES)
    jcfg, tcfg = jmodel.get_config(arch), tmodel.get_config(arch)
    for active in (False, True):
        assert troof.analytic_params(tcfg, active=active) == jroof.analytic_params(
            jcfg, active=active)
    for shape in tmc.SHAPES:
        assert troof.model_flops(arch, shape) == jroof.model_flops(arch, shape)


def synthetic(arch, shape, *, ok=True, bytes_accessed=3.3e12, temp=5 * 2**30):
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": "single", "ok": False, "error": "x"}
    return {"arch": arch, "shape": shape, "mesh": "single", "devices": 256,
            "memory": {"temp_size_in_bytes": temp},
            "recon": {"flops": 2.5e14, "bytes_accessed": bytes_accessed,
                      "collective_bytes": 4.1e10},
            "ok": True}


def test_analyze_cell_and_table_match_reference(tmp_path, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(troof, name, getattr(jroof, name))
    rows = {}
    for i, (arch, shape) in enumerate([("qwen2.5-32b", "train_4k"),
                                       ("deepseek-moe-16b", "prefill_32k"),
                                       ("mamba2-1.3b", "decode_32k"),
                                       ("gemma3-12b", "long_500k")]):
        path = tmp_path / f"{arch}__{shape}__single.json"
        path.write_text(json.dumps(synthetic(arch, shape, bytes_accessed=10.0 ** (10 + i),
                                             ok=i != 3)))
        rows[path] = (troof.analyze_cell(path), jroof.analyze_cell(path))
    for got, want in rows.values():
        assert got == want
    assert troof.render_table([g for g, _ in rows.values()]) == jroof.render_table(
        [w for _, w in rows.values()])


def test_null_memory_fields(tmp_path):
    path = tmp_path / "c__train_4k__single.json"
    path.write_text(json.dumps(synthetic("qwen2.5-32b", "train_4k", bytes_accessed=None,
                                         temp=None)))
    row = troof.analyze_cell(path)
    assert row["memory_s"] is None and row["temp_gib"] is None
    assert row["dominant"] == "compute"  # 2.5e14 / 989e12 against 4.1e10 / 900e9
    assert row["compute_s"] == 2.5e14 / 989e12 and row["collective_s"] == 4.1e10 / 900e9
    assert "| n/a |" in troof.render_table([row])
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (989e12, 3.35e12, 900e9)


@pytest.fixture
def tiny(monkeypatch):
    for name, (B, S) in {"train_4k": (8, 32), "prefill_32k": (8, 32),
                         "decode_32k": (8, 16)}.items():
        monkeypatch.setitem(tmc.SHAPES, name, dict(tmc.SHAPES[name], global_batch=B,
                                                   seq_len=S))
    for arch, layers in (("deepseek-moe-16b", 3), ("gemma3-12b", 18), ("zamba2-2.7b", 6)):
        monkeypatch.setitem(tconfigs.REGISTRY, arch,
                            tconfigs.get(arch).reduced(dtype="bfloat16", num_layers=layers))
    return make_mesh_auto((4, 2), ("data", "model"), ["meta"] * 8)


@pytest.mark.parametrize("arch,impl", [("deepseek-moe-16b", "a2a"),
                                       ("deepseek-moe-16b", "gather"),
                                       ("gemma3-12b", "gather"), ("zamba2-2.7b", "gather")])
def test_dryrun_records_every_field_and_reconstructs_depth(tiny, tmp_path, arch, impl):
    r = dryrun.run_cell(arch, "train_4k", False, tmp_path, mesh=tiny, loss_chunk=8,
                        moe_impl=impl)
    saved = json.loads((tmp_path / f"{arch}__train_4k__single.json").read_text())
    assert saved == json.loads(json.dumps(r))
    assert set(r) >= {"arch", "shape", "mesh", "devices", "meta", "memory", "cost",
                      "collectives", "collective_bytes_total", "recon", "run_s", "ok"}
    assert r["devices"] == 8 and r["ok"]
    mem = r["memory"]
    assert mem["temp_size_in_bytes"] is None and mem["generated_code_size_in_bytes"] is None
    assert 0 < mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    assert r["cost"]["bytes_accessed"] is None and r["cost"]["transcendentals"] is None
    assert r["cost"]["flops"] * 8 == r["cost"]["flops_program"] > 0
    assert ("all-to-all" in r["collectives"]) == (impl == "a2a")
    rec = r["recon"]
    assert rec["n_periods"] * rec["period"] == tconfigs.get(arch).num_layers
    assert rec["formula"] == {"flops": rec["flops"], "collective_bytes": rec["collective_bytes"]}
    assert rec["depth1"]["cost"]["flops"] < rec["depth2"]["cost"]["flops"] < rec["flops"]
    assert troof.analyze_cell(tmp_path / f"{arch}__train_4k__single.json")["ok"]


def test_dryrun_flops_are_the_single_device_steps(tiny, tmp_path):
    """On a 1 × 1 meta mesh the cell's step is the plain train step: the
    same FLOPs as ``FlopCounterMode`` counts for it."""
    mesh = make_mesh_auto((1, 1), ("data", "model"), ["meta"])
    r = dryrun.run_cell("gemma3-12b", "train_4k", False, tmp_path, mesh=mesh, loss_chunk=8)
    cfg = tconfigs.get("gemma3-12b")
    state = tstep.train_state_init(0, cfg, device="meta")
    batch = {k: torch.empty((8, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    with FlopCounterMode(display=False) as fc:
        tstep.make_train_step(cfg, loss_chunk=8)(state, batch)
    assert r["cost"]["flops_program"] == fc.get_total_flops()
    assert r["collectives"] == {}  # one position: nothing gathered or re-placed


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_inference_cells(tiny, tmp_path, shape):
    r = dryrun.run_cell("deepseek-moe-16b", shape, False, tmp_path, mesh=tiny,
                        moe_impl="auto")
    assert r["meta"]["kind"] == ("prefill" if shape == "prefill_32k" else "decode")
    if shape == "decode_32k":  # decode runs every layer: the count is the program's
        assert set(r["recon"]) == {"flops", "bytes_accessed", "collective_bytes"}
        assert r["memory"]["alias_size_in_bytes"] > 0  # the donated cache
    else:
        assert r["recon"]["formula"]["flops"] == r["recon"]["flops"]
        assert r["memory"]["alias_size_in_bytes"] == 0


def test_dryrun_cli(tiny, tmp_path, monkeypatch, capsys):
    import repro_torch.launch.mesh as lm

    monkeypatch.setattr(lm, "make_production_mesh", lambda multi_pod=False, devices=None: tiny)
    dryrun.main(["--arch", "zamba2-2.7b", "--shape", "decode_32k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK  zamba2-2.7b") and "all cells ran" in out
    assert (tmp_path / "zamba2-2.7b__decode_32k__single.json").exists()
    troof.main(["--dir", str(tmp_path), "--mesh", "single"])
    assert "| zamba2-2.7b | decode_32k |" in capsys.readouterr().out
