"""The port's roofline and report (``repro_torch.analysis.roofline`` and
``report``) against the reference's on the same artifacts: every row
field and ``model_flops_for`` equal once the constants are rescaled, and
the three tables and the AUTOGEN injection in the reference's text
layout. The artifacts are the reference's schema, with and without the
port's extra keys."""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import json

import pytest

import repro.analysis.report as ref_report
import repro.analysis.roofline as ref_roofline
import repro_torch.analysis.report as report
import repro_torch.analysis.roofline as roofline


def _art(arch, shape, kind, mesh, n, flops, hbm, coll, peak, S, B, active, port=False):
    art = {
        "cell": f"{arch}__{shape}__{mesh}__baseline", "status": "OK", "arch": arch,
        "shape": shape, "kind": kind, "mesh": mesh, "variant": "baseline", "n_devices": n,
        "lower_s": 1.0, "compile_s": 2.0, "params_total": active, "params_active": active,
        "seq_len": S, "global_batch": B, "accum_steps": 1, "seq_axis": None,
        "memory": {"argument_bytes": peak // 3, "output_bytes": 0,
                   "temp_bytes": peak - peak // 3, "peak_bytes": peak},
        "cost": {"xla_flops": None if port else flops / 3, "xla_bytes_accessed": None,
                 "flops": flops, "hbm_bytes": hbm, "unknown_trip_counts": 0},
        "collectives": coll,
        "collective_counts": {f"{k}_count": 3.0 for k in coll},
        "collective_top_sources": [],
    }
    if port:
        art.update(fits=peak <= 80 * 2**30, kernel_work={}, n_ops=10, variant_note=None)
    return art


ARTS = [
    _art("llama3.2-1b", "train_4k", "train", "pod16x16", 256, 6.5e14, 1.9e12,
         {"all-gather": 2.6e9, "reduce-scatter": 1.5e8}, 175 * 2**30, 4096, 256, 1235814400,
         port=True),
    _art("llama3.2-1b", "decode_32k", "decode", "pod16x16", 256, 2.1e10, 3.8e10,
         {"all-gather": 6.3e9}, 7 * 2**30, 32768, 128, 1235814400),
    _art("smollm-135m", "prefill_32k", "prefill", "pod16x16", 256, 9.0e13, 1.0e11,
         {"all-gather": 2.7e8}, 30 * 2**30, 32768, 32, 134515008, port=True),
    _art("deepseek-v3-671b", "train_4k", "train", "pod2x16x16", 512, 2.3e17, 1.0e15,
         {"all-gather": 1.6e12, "all-reduce": 1e5}, 7520 * 2**30, 4096, 256, 38238533632),
    _art("zamba2-1.2b", "long_500k", "decode", "pod2x16x16", 512, 3.0e9, 4.0e11,
         {}, 60 * 2**30, 524288, 1, 1225003904),
    {"cell": "hubert-xlarge__decode_32k__pod16x16__baseline", "status": "SKIP",
     "reason": "encoder-only arch has no autoregressive decode step"},
]


@pytest.fixture
def arts_dir(tmp_path):
    for a in ARTS:
        (tmp_path / f"{a['cell']}.json").write_text(json.dumps(a))
    return tmp_path


@pytest.fixture
def ref_constants(monkeypatch):
    """The port's roofline with the reference's rates and notes."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(ref_roofline, name))
    monkeypatch.setattr(roofline, "_note", ref_roofline._note)


def test_constants_are_the_h100_datasheet_rates():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert [f.name for f in dataclasses.fields(roofline.RooflineRow)] == \
        [f.name for f in dataclasses.fields(ref_roofline.RooflineRow)]


@pytest.mark.parametrize("art", [a for a in ARTS if a["status"] == "OK"],
                         ids=lambda a: a["cell"])
def test_rows_equal_the_reference_after_rescaling(art):
    got, want = roofline.analyze_artifact(art), ref_roofline.analyze_artifact(art)
    assert roofline.model_flops_for(art) == ref_roofline.model_flops_for(art)
    assert got.compute_s * roofline.PEAK_FLOPS == pytest.approx(
        want.compute_s * ref_roofline.PEAK_FLOPS, rel=1e-15)
    assert got.memory_s * roofline.HBM_BW == pytest.approx(
        want.memory_s * ref_roofline.HBM_BW, rel=1e-15)
    assert got.collective_s == want.collective_s
    for f in ("cell", "arch", "shape", "kind", "mesh", "variant", "n_devices", "model_flops",
              "hlo_flops_global", "useful_ratio", "mem_gib"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.step_time_bound() == max(got.compute_s, got.memory_s, got.collective_s)


@pytest.mark.parametrize("art", [a for a in ARTS if a["status"] == "OK"],
                         ids=lambda a: a["cell"])
def test_rows_equal_the_reference_at_its_constants(art, ref_constants):
    assert dataclasses.asdict(roofline.analyze_artifact(art)) == \
        dataclasses.asdict(ref_roofline.analyze_artifact(art))


def test_skipped_cells_have_no_row():
    assert roofline.analyze_artifact(ARTS[-1]) is None


def test_tables_have_the_reference_layout(arts_dir, monkeypatch, ref_constants):
    monkeypatch.setattr(ref_report, "ARTIFACTS", arts_dir)
    monkeypatch.setattr(report, "ARTIFACTS", arts_dir)
    for mesh in (None, "pod16x16", "pod2x16x16"):
        got = roofline.format_table(roofline.load_rows(arts_dir, mesh=mesh))
        assert got == ref_roofline.format_table(ref_roofline.load_rows(arts_dir, mesh=mesh))
    assert report.dryrun_table() == ref_report.dryrun_table()
    for mesh in ("pod16x16", "pod2x16x16"):
        assert report.roofline_table(mesh) == ref_report.roofline_table(mesh)


def test_port_notes_name_the_ports_levers(arts_dir):
    rows = roofline.load_rows(arts_dir)
    assert len(rows) == 5
    text = " ".join(r.note for r in rows)
    assert "Pallas" not in text and "MXU" not in text
    assert any("tensor-parallel" in r.note or "CUDA" in r.note for r in rows)


def test_inject_and_main_write_between_the_markers(arts_dir, tmp_path, monkeypatch):
    text = "# t\n\nprose\n"
    for tag, body in (("a", "one"), ("a", "two"), ("b", "x")):
        assert report.inject(text, tag, body) == ref_report.inject(text, tag, body)
        text = report.inject(text, tag, body)
    assert text.count("<!-- AUTOGEN:a BEGIN -->") == 1 and "two" in text and "one" not in text
    doc = tmp_path / "docs" / "dryrun_torch.md"
    monkeypatch.setattr(report, "ARTIFACTS", arts_dir)
    monkeypatch.setattr(report, "DOC", doc)
    doc.parent.mkdir()
    doc.write_text("# The port's dry run\n\nhand-kept text\n")
    report.main()
    out = doc.read_text()
    assert out.startswith("# The port's dry run\n\nhand-kept text\n")
    for tag in ("dryrun", "roofline_pod1", "roofline_pod2"):
        assert f"<!-- AUTOGEN:{tag} BEGIN -->" in out and f"<!-- AUTOGEN:{tag} END -->" in out
    assert "| hubert-xlarge | decode_32k | pod16x16 | SKIP |" in out
    report.main()
    assert doc.read_text() == out
