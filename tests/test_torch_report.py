"""The port's ``launch/report.py`` against the JAX package's.

The same dry-run records (JSON lists with the keys of JAX's dry run: a
16x16 file with a skip marker and an error marker, a 2x16x16 file, and two
hill-climb files, one of them failed) fill the same template.  JAX's
``report.main`` reads ``EXPERIMENTS.md`` and ``results/``; both are
monkeypatched to a temporary directory, so nothing of the reference is
read or written.  The port's ``roofline`` reads the reference's constants
(``test_torch_roofline.reference_constants``), so its tables are JAX's
but for the one recommendation that names the Hopper flash kernel where
JAX names its Pallas kernel (``test_torch_roofline.py``): but for the
fix column of those rows, the port's filled text must equal JAX's exactly,
line for line, and the fill must be idempotent, the CLI must write only the file it is given, and a dry-run
record the port's CLI wrote must fill a template.
"""
import json

import pytest

from repro.launch import report as jreport
from repro_torch.launch import dryrun, report
from test_torch_roofline import reference_constants  # noqa: F401  (a fixture)

TEMPLATE = """# Experiments

## Roofline

<!-- ROOFLINE_16x16 -->
(filled by the report)
<!-- /ROOFLINE_16x16 -->

<!-- ROOFLINE_2x16x16 -->
<!-- /ROOFLINE_2x16x16 -->

## Perf log

<!-- PERF_LOG -->
<!-- /PERF_LOG -->

Trailing text stays.
"""


def _rec(arch, shape, kind, c, m, x, flops, chips=256, **kw):
    terms = {"compute_s": c, "memory_s": m, "collective_s": x}
    dom = max(terms, key=terms.get)
    terms.update(dominant=dom, bound_s=terms[dom])
    per_op = {k: {"result_bytes": 1e6 * (i + 1), "wire_bytes": 2e6 * (i + 1) * (k == "all-gather"
                                                                              or 1),
                  "count_in_text": i + 1}
              for i, k in enumerate(("all-reduce", "all-gather", "reduce-scatter"))}
    return {"arch": arch, "shape": shape, "kind": kind, "chips": chips, "roofline": terms,
            "model_flops": flops, "useful_flops_ratio": 0.83,
            "collectives_corrected": {"wire_bytes": 3e6, "per_op": per_op}, **kw}


def _records(tmp_path):
    d16 = [_rec("llama3.2-3b", "train_4k", "train", 0.21, 0.4, 0.11, 2.1e18),
           _rec("llama3.2-3b", "decode_32k", "decode", 1e-4, 0.013, 2e-3, 1.3e12),
           _rec("mixtral-8x22b", "prefill_32k", "prefill", 0.9, 0.2, 1.7, 4.5e17),
           {"arch": "llama3.2-3b", "shape": "long_500k", "skipped": True, "reason": "r"},
           {"arch": "xlstm-1.3b", "shape": "train_4k", "error": "something broke " * 8}]
    d2 = [_rec("llama3.2-3b", "train_4k", "train", 0.1, 0.2, 0.3, 2.1e18, chips=512)]
    hc_a = [_rec("llama3.2-3b", "train_4k", "train", 0.2, 0.1, 0.05, 2.1e18)]
    paths = {}
    for name, rows in (("dryrun_16x16.json", d16), ("dryrun_2x16x16.json", d2),
                       ("hc_seqpar.json", hc_a), ("hc_broken.json", [{"error": "x"}])):
        paths[name] = tmp_path / name
        paths[name].write_text(json.dumps(rows))
    return paths


@pytest.mark.parametrize("multi_pod,hc", [(False, False), (True, False), (True, True)])
def test_fill_equals_jax_report(tmp_path, monkeypatch, reference_constants, multi_pod, hc):
    res = tmp_path / "results"
    res.mkdir()
    paths = _records(res)
    if not multi_pod:
        paths.pop("dryrun_2x16x16.json").unlink()
    if not hc:
        for name in ("hc_seqpar.json", "hc_broken.json"):
            paths.pop(name).unlink()
    exp = tmp_path / "EXPERIMENTS.md"
    exp.write_text(TEMPLATE)
    monkeypatch.setattr(jreport, "EXP", str(exp))
    monkeypatch.setattr(jreport, "RES", str(res))
    jreport.main()
    want = exp.read_text()
    got = report.fill(TEMPLATE, str(res / "dryrun_16x16.json"),
                      str(res / "dryrun_2x16x16.json") if multi_pod else None,
                      sorted(str(p) for n, p in paths.items() if n.startswith("hc_")))
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    reworded = 0
    for g, w in zip(got_lines, want_lines):
        if "Hopper flash kernel" in g:          # the fix column's one reworded sentence
            assert "Pallas flash kernel" in w
            g, w = g.rsplit("|", 2)[0], w.rsplit("|", 2)[0]
            reworded += 1
        assert g == w
    assert reworded == 1                        # the memory-bound train row
    assert got != TEMPLATE and got.endswith("Trailing text stays.\n")
    again = report.fill(got, str(res / "dryrun_16x16.json"),
                        str(res / "dryrun_2x16x16.json") if multi_pod else None,
                        sorted(str(p) for n, p in paths.items() if n.startswith("hc_")))
    assert again == got                                       # idempotent


def test_cli_writes_only_its_target(tmp_path, reference_constants, capsys):
    paths = _records(tmp_path)
    target = tmp_path / "REPORT.md"
    target.write_text(TEMPLATE)
    before = {p.name: p.read_text() for p in tmp_path.iterdir() if p != target}
    report.main(["--dryrun", str(paths["dryrun_16x16.json"]),
                 "--multi-pod", str(paths["dryrun_2x16x16.json"]),
                 "--hc", str(paths["hc_seqpar.json"]), "--target", str(target)])
    assert f"{target} updated" in capsys.readouterr().out
    text = target.read_text()
    assert "| llama3.2-3b | train_4k |" in text and "| seqpar | llama3.2-3b×train_4k |" in text
    assert {p.name: p.read_text() for p in tmp_path.iterdir() if p != target} == before


def test_report_reads_the_ports_dry_run(tmp_path, capsys):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--out", str(out)])
    target = tmp_path / "REPORT.md"
    target.write_text(TEMPLATE)
    report.main(["--dryrun", str(out), "--target", str(target)])
    text = target.read_text()
    row = [line for line in text.splitlines() if line.startswith("| whisper-base | decode_32k")]
    assert len(row) == 1 and "ERROR" not in row[0]
    assert "<!-- ROOFLINE_2x16x16 -->\n<!-- /ROOFLINE_2x16x16 -->" in text
