"""Generate the data-driven sections of ``docs/dryrun_torch.md`` from the
port's dry-run artifacts (port of ``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report

Rewrites everything between the AUTOGEN markers in docs/dryrun_torch.md
(the dry-run table and the roofline tables of both meshes) from
artifacts/dryrun_torch/*.json; the text around them is kept by hand.
The reference's EXPERIMENTS.md is not touched.
"""

from __future__ import annotations

import json
from pathlib import Path

from .roofline import analyze_artifact

ROOT = Path(__file__).resolve().parents[3]
ARTIFACTS = ROOT / "artifacts" / "dryrun_torch"
DOC = ROOT / "docs" / "dryrun_torch.md"

BEGIN = "<!-- AUTOGEN:{} BEGIN -->"
END = "<!-- AUTOGEN:{} END -->"


def _load(variant="baseline"):
    arts = []
    for f in sorted(ARTIFACTS.glob("*.json")):
        a = json.loads(f.read_text())
        if a.get("variant", "baseline") == variant or a.get("status") == "SKIP":
            arts.append(a)
    return arts


def dryrun_table() -> str:
    arts = _load()
    lines = [
        "| arch | shape | mesh | status | GiB/dev | HLO TFLOPs/dev | "
        "HBM GB/dev | collective GiB/dev | accum |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    seen = set()
    for a in arts:
        key = a["cell"]
        if key in seen:
            continue
        seen.add(key)
        parts = key.split("__")
        arch, shape, mesh = parts[0], parts[1], parts[2]
        if a["status"] == "SKIP":
            lines.append(
                f"| {arch} | {shape} | {mesh} | SKIP | — | — | — | — | — |"
            )
            continue
        lines.append(
            "| {arch} | {shape} | {mesh} | OK | {mem:.1f} | {fl:.2f} | "
            "{hbm:.1f} | {coll:.2f} | {acc} |".format(
                arch=arch, shape=shape, mesh=mesh,
                mem=a["memory"]["peak_bytes"] / 2**30,
                fl=a["cost"]["flops"] / 1e12,
                hbm=a["cost"]["hbm_bytes"] / 1e9,
                coll=sum(a["collectives"].values()) / 2**30,
                acc=a.get("accum_steps", 1),
            )
        )
    return "\n".join(lines)


def roofline_table(mesh="pod16x16") -> str:
    arts = [a for a in _load() if a.get("status") == "OK" and a["mesh"] == mesh]
    lines = [
        "| arch × shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful % | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for a in arts:
        r = analyze_artifact(a)
        lines.append(
            f"| {r.arch} × {r.shape} | {r.compute_s:.3f} | {r.memory_s:.3f} | "
            f"{r.collective_s:.3f} | **{r.dominant}** | {r.model_flops:.2e} | "
            f"{r.useful_ratio:.1%} | {r.note} |"
        )
    return "\n".join(lines)


def inject(text: str, tag: str, content: str) -> str:
    b, e = BEGIN.format(tag), END.format(tag)
    if b not in text:
        return text + f"\n\n{b}\n{content}\n{e}\n"
    pre, rest = text.split(b, 1)
    _, post = rest.split(e, 1)
    return pre + b + "\n" + content + "\n" + e + post


def main():
    text = DOC.read_text() if DOC.exists() else "# The port's dry run\n"
    text = inject(text, "dryrun", dryrun_table())
    text = inject(text, "roofline_pod1", roofline_table("pod16x16"))
    text = inject(text, "roofline_pod2", roofline_table("pod2x16x16"))
    DOC.parent.mkdir(parents=True, exist_ok=True)
    DOC.write_text(text)
    print(f"wrote {DOC}")


if __name__ == "__main__":
    main()
