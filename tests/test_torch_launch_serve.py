"""The port's serving driver (``repro_torch.launch.serve``) on the CPU.

Against the reference's driver (``repro.launch.serve.main``, run in this
process with ``sys.argv`` set and its output captured), line for line with
the tok/s masked: the plain run, ``--page-ttl 8``, ``--snapshot-window 6``
and a durable run (the directory's path masked; both directories byte for
byte).  The weights differ (each
package draws its own from the seed), and no printed line depends on them.

The port alone: ``--gateway``, ``--wal-dir`` twice (the second run prints
the recovery line), ``--device-budget``, ``--shards 2`` under both routings,
``--snapshot-window 2`` (``SNAPSHOT_GONE``), ``--index-impl reference``; the
returned index's live pairs against a host model; and the sharding
options the decoder takes (``act_spec``, ``dispatch_spec``, an a2a
``moe_mesh``) with the reference's semantics: checks against the current
mesh that leave the values as they are.
"""

import dataclasses
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve.kv_index import PAGE_BITS  # noqa: E402
from repro_torch.sharding import P  # noqa: E402

BASE = ["--arch", "musicgen-medium", "--reduced", "--batch", "4", "--steps", "32",
        "--max-len", "64"]


def masked(text: str, wal_dir=None) -> list[str]:
    text = re.sub(r"\([0-9.]+ tok/s\)", "(X tok/s)", text)
    if wal_dir is not None:
        text = text.replace(str(wal_dir), "<dir>")
    return text.strip().splitlines()


def run_port(capsys, *extra):
    idx = tserve.main([*BASE, "--device", "cpu", *extra])
    return idx, capsys.readouterr().out


def run_reference(capsys, monkeypatch, *extra):
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve", *BASE, *extra])
    jserve.main()
    return capsys.readouterr().out


def live_pairs(idx) -> dict:
    """Every (key, slot) the index holds but the seed key."""
    from repro_torch.core.state import EMPTY, MAX_VALID

    st = idx.state
    keys, vals = st.keys.reshape(-1), st.vals.reshape(-1)
    live = (keys != EMPTY) & (keys != MAX_VALID)
    return dict(zip(keys[live].tolist(), vals[live].tolist()))


def host_model(batch: int, steps: int) -> dict:
    """Sequence ``b``'s page ``p`` at slot ``b * 1000 + p``."""
    return {
        (b << PAGE_BITS) | p: b * 1000 + p
        for b in range(batch)
        for p in range((steps - 1) // tserve.PAGE_TOKENS + 1)
    }


@pytest.mark.parametrize(
    "extra",
    [(), ("--page-ttl", "8"), ("--snapshot-window", "6")],
    ids=["plain", "page-ttl", "snapshot-window-6"],
)
def test_driver_prints_the_reference_lines(capsys, monkeypatch, extra):
    want = run_reference(capsys, monkeypatch, *extra)
    idx, got = run_port(capsys, *extra)
    assert masked(got) == masked(want)
    assert len(masked(got)) >= 2
    if not extra:
        assert live_pairs(idx) == host_model(4, 32)


def test_durable_driver_prints_the_reference_lines(capsys, monkeypatch, tmp_path):
    jdir, tdir = tmp_path / "reference", tmp_path / "port"
    want = run_reference(capsys, monkeypatch, "--wal-dir", str(jdir))
    _, got = run_port(capsys, "--wal-dir", str(tdir))
    assert masked(got, tdir) == masked(want, jdir)
    assert masked(got, tdir)[-1] == "index durable at seq 2 in <dir>"
    # the two durable directories hold the same bytes
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    for f in files:
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f


def test_gateway_then_recovery(capsys, tmp_path):
    idx, out = run_port(capsys, "--gateway", "--wal-dir", str(tmp_path))
    lines = masked(out, tmp_path)
    assert lines[-2] == ("gateway exactly-once ✓ (16 requests in 2 batches, "
                         "1 duplicates deduped)")
    assert lines[-1] == "index durable at seq 2 in <dir>"
    idx, out = run_port(capsys, "--wal-dir", str(tmp_path))
    lines = masked(out, tmp_path)
    assert lines[0] == "recovered KV index from <dir> (seq 2, 8 pages)"
    assert lines[-1] == "index durable at seq 4 in <dir>"
    assert live_pairs(idx) == host_model(4, 32)


def test_device_budget(capsys):
    idx, out = run_port(capsys, "--device-budget", "500000")
    assert re.search(r"tiered residency ✓ \(\d+ device-resident bytes, budget 500000\)", out)
    assert idx.resident_bytes <= 500000
    assert "page enumeration in order ✓ (2 pages for seq 0)" in out


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_shards(capsys, routing):
    idx, out = run_port(capsys, "--shards", "2", "--index-routing", routing)
    assert f"kv index tracks 8 pages on 2 shards ({routing})" in out
    assert "page enumeration in order ✓ (2 pages for seq 0)" in out
    assert len(idx.mesh.devices) == 2 and all(d.type == "cpu" for d in idx.mesh.devices)


def test_snapshot_window_slides_past(capsys):
    _, out = run_port(capsys, "--snapshot-window", "2")
    assert masked(out)[-1] == "snapshot window slid past version 2 → SNAPSHOT_GONE ✓"


def test_reference_engine_and_longer_run(capsys):
    idx, out = run_port(capsys, "--index-impl", "reference", "--steps", "40", "--batch", "3")
    assert "decoded 40 steps × batch 3" in out
    assert "page enumeration in order ✓ (3 pages for seq 0)" in out
    assert live_pairs(idx) == host_model(3, 40)


def test_sharding_options_are_refused():
    """Once refused, the sharding options now carry the reference's
    semantics: ``act_spec`` and ``dispatch_spec`` are checked against the
    current mesh, raise outside one (as ``with_sharding_constraint`` does)
    and leave the values as they are; an a2a ``moe_mesh`` routes the MoE
    layer through ``moe_ffn_a2a``."""
    cfg = tmodel.get_config("deepseek-moe-16b").reduced(dtype="float32",
                                                        moe_capacity_factor=8.0)
    params = tmodel.init_params(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 4), dtype=torch.int32)
    plain = ttf.forward_hidden(params, cfg, tokens)
    mesh = make_mesh_auto((4, 2), ("data", "model"), ["cpu"] * 8)
    act = P("data", "model", None)
    with pytest.raises(RuntimeError, match="act_spec .* needs a mesh"):
        ttf.forward_hidden(params, cfg, tokens, act_spec=act)
    with pytest.raises(TypeError, match="act_spec must be a PartitionSpec"):
        ttf.forward_hidden(params, cfg, tokens, act_spec=("data", None, "model"))
    with mesh:
        assert torch.equal(ttf.forward_hidden(params, cfg, tokens, act_spec=act), plain)
        with pytest.raises(ValueError, match="not found in mesh"):
            ttf.forward_hidden(params, cfg, tokens, act_spec=P("pod", None, None))
    x = torch.randn(16, cfg.d_model)
    lp = {k: v[0] for k, v in params["layers"].items()}
    dcfg = dataclasses.replace(cfg, dispatch_spec=P("model", "data", None))
    with pytest.raises(RuntimeError, match="dispatch_spec .* needs a mesh"):
        tmoe.moe_ffn(x, lp, dcfg)
    with mesh:
        assert torch.equal(tmoe.moe_ffn(x, lp, dcfg), tmoe.moe_ffn(x, lp, cfg))
    a2a = ttf.forward(params, dataclasses.replace(cfg, moe_impl="a2a", moe_mesh=mesh), tokens)
    torch.testing.assert_close(a2a, ttf.forward(params, cfg, tokens), rtol=1e-5, atol=1e-5)
    # a2a without a mesh is the gather path, as in the reference
    out = ttf.forward(params, dataclasses.replace(cfg, moe_impl="a2a"), tokens)
    assert torch.equal(out, ttf.forward(params, cfg, tokens))


def test_entry_points_default_to_the_card():
    cfg = tmodel.get_config("qwen2.5-32b").reduced()
    if torch.cuda.is_available():
        assert tmodel.init_params(0, cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(BASE)
