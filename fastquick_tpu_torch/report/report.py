"""Final QC report: R-free replica of the reference visualization stage.

Replicates every panel of bin/RPlotScript.R and the section layout of
bin/FinalReport.rmd in matplotlib + a single self-contained HTML file:

- page 1 (rmd "Depth Distribution", 2x2): depth distribution with the
  findBump window (RPlotScript.R:59-101,138-143), cycle-vs-empirical
  quality (:146-157), reported-vs-empirical quality with the y=x guide
  (:160-166), base count by reported quality (:168-169);
- page 2 (rmd "Summary Plot", 2x2): normalized depth vs GC percentile
  with the GC secondary axis (:171-196), the depth bar chart (:242-249),
  raw+adjusted insert size rebinned to 10bp per create.DenDist
  (:102-120,199-223), the summary-fraction bar chart (:251-258);
- "Genetic Ancestry Plot": PC1/PC2 and (when the SVD panel has >=4 PCs)
  PC3/PC4 scatters over the reference-panel coordinates with the exact
  1000g population color scale (:263-333);
- tables: FASTQ list (.FASTQ.csv), data production (.Sequence.csv) and
  the .Summary table, as in FinalReport.rmd:315-341.

Missing required inputs are an error (rc != 0), mirroring the R scripts
which abort on a failed read.table; they never emit a partial page.
"""

from __future__ import annotations

import base64
import csv
import io
import os

import numpy as np

from ..params import ParamList
from ..utils.logging import error, notice

# scale_color_manual values, RPlotScript.R:269-275
POP_COLORS = {
    "ESN": "#FFCD00", "GWD": "#FFB900", "LWK": "#CC9933", "MSL": "#E1B919",
    "YRI": "#FFB933", "ACB": "#FF9900", "ASW": "#FF6600", "CLM": "#CC3333",
    "MXL": "#E10033", "PEL": "#FF0000", "PUR": "#CC3300", "CDX": "#339900",
    "CHB": "#ADCD00", "CHS": "#00FF00", "JPT": "#008B00", "KHV": "#00CC33",
    "CEU": "#0000FF", "FIN": "#00C5CD", "GBR": "#00EBFF", "IBS": "#6495ED",
    "TSI": "#00008B", "BEB": "#8B008B", "GIH": "#9400D3", "ITU": "#B03060",
    "PJL": "#E11289", "STU": "#FF00FF", "AFR": "#FFCD33",
    "AFR/AMR": "#FF9900", "AMR": "#FF3D3D", "EAS": "#ADFF33",
    "EUR": "#64EBFF", "SAS": "#FF30FF", "UserSample": "#000000",
}
TEAL = "#00BFC4"  # ggplot default line color used throughout the R script


class ReportInputError(RuntimeError):
    pass


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise ReportInputError(f"required report input missing: {path}")
    return path


def _load_table(path: str) -> np.ndarray:
    rows = []
    with open(_require(path)) as fh:
        for line in fh:
            parts = line.split()
            if parts:
                rows.append([float(x) for x in parts])
    if not rows:
        raise ReportInputError(f"report input is empty: {path}")
    width = max(len(r) for r in rows)
    return np.array([r + [0.0] * (width - len(r)) for r in rows])


def find_bump(pos: np.ndarray, cnt: np.ndarray, num_limits: int = 3):
    """RPlotScript.R:59-101 window heuristic: walk out from the modal
    value and stop after `num_limits` upward turning points each way.
    Returns (min_idx, max_idx) into the arrays."""
    pivot = int(np.argmax(cnt))
    lo = hi = pivot
    n = 0
    prev = cnt[pivot]
    for i in range(pivot, -1, -1):
        if n == num_limits:
            break
        if cnt[i] > prev * 1.2:
            n += 1
        prev = cnt[i]
        lo = i
    n = 0
    prev = cnt[pivot]
    for i in range(pivot, len(cnt)):
        if n == num_limits:
            break
        if cnt[i] > prev * 1.2:
            n += 1
        prev = cnt[i]
        hi = i
    return lo, hi


def create_den_dist(pos: np.ndarray, cnt: np.ndarray):
    """create.DenDist (RPlotScript.R:102-120): greedy 10-unit rebinning.
    Quirks preserved: the trailing partial bin is never flushed, and a
    (-1, 0) seed row remains in the output."""
    out = [(-1.0, 0.0)]
    if len(pos) == 0:
        return np.array(out)
    start, count = pos[0], cnt[0]
    for p, c in zip(pos, cnt):
        if p < start + 10:
            count += c
        else:
            out.append((start, count))
            start, count = p, c
    arr = np.array(out)
    return arr[np.argsort(arr[:, 0])]


def _fig_to_b64(fig) -> str:
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _read_csv_table(path: str):
    with open(_require(path)) as fh:
        return [row for row in csv.reader(fh) if row]


def _html_table(rows, caption: str) -> str:
    if not rows:
        return ""
    head = "".join(f"<th>{c}</th>" for c in rows[0])
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>"
        for r in rows[1:])
    return (f"<table><caption>{caption}</caption>"
            f"<tr>{head}</tr>{body}</table>")


def _panel_depth_pages(prefix: str, plt):
    """Pages 1+2 of the reference report (8 panels, 2 figures)."""
    # ---- q1: depth distribution, bump-windowed (rows 2:150) ----
    dd = _load_table(prefix + ".DepthDist")[1:150]
    lo, hi = find_bump(dd[:, 0], dd[:, 1])
    fig1, axes = plt.subplots(2, 2, figsize=(10, 7))
    ax = axes[0, 0]
    ax.plot(dd[:, 0], dd[:, 1], color=TEAL)
    if hi > lo:
        ax.set_xlim(dd[lo, 0], dd[hi, 0])
    ax.set_xlabel("Depth")
    ax.set_ylabel("SiteCount")
    ax.set_title("Depth Distribution")

    # ---- q2: cycle vs empirical quality (truncate at first 0 count) ----
    cyc = _load_table(prefix + ".EmpCycleDist")
    max_cycle = len(cyc)
    for i in range(min(150, len(cyc))):
        max_cycle = i + 1
        if cyc[i, 2] == 0:
            break
    cyc = cyc[:max_cycle]
    ax = axes[0, 1]
    ax.plot(cyc[:, 0], cyc[:, 3], color=TEAL)
    ax.set_xlim(0, max_cycle)
    ax.set_ylim(0, 45)
    ax.set_xlabel("SequencingCycle")
    ax.set_ylabel("EmpiricalQuality")
    ax.set_title("Sequencing Cycle V.S. Empirical Quality", fontsize=10)

    # ---- q3: reported vs empirical quality, y=x guide (rows 1:40) ----
    rep = _load_table(prefix + ".EmpRepDist")[:40]
    ax = axes[1, 0]
    ax.plot(rep[:, 0], rep[:, 3], color=TEAL)
    ax.plot([0, 40], [0, 40], color="purple", linestyle=":")
    ax.set_xlim(0, 40)
    ax.set_ylim(0, 40)
    ax.set_xlabel("SequencingQuality")
    ax.set_ylabel("EmpiricalQuality")
    ax.set_title("Sequencing Quality V.S. Empirical Quality", fontsize=10)

    # ---- q4: base count by reported quality ----
    ax = axes[1, 1]
    ax.plot(rep[:, 0], rep[:, 2], color="red", linestyle=":")
    ax.set_xlim(0, 40)
    ax.set_xlabel("SequencingQuality")
    ax.set_ylabel("BaseCount")
    ax.set_title("Base Count Distribution")
    fig1.tight_layout()

    # ---- q5: normalized depth vs GC percentile w/ GC secondary axis ----
    gc = _load_table(prefix + ".GCDist")[1:101]
    gcv, sites, nmd = gc[:, 0], gc[:, 2], gc[:, 3]
    total = sites.sum() or 1.0
    cum = np.cumsum(sites) / total * 100.0
    xs = np.arange(0.0, 100.0001, 0.05)
    # R approx(): linear interp, NaN outside the data range
    gx = np.interp(xs, cum, gcv, left=np.nan, right=np.nan)
    num = np.cumsum(sites * nmd)
    den = np.cumsum(sites)
    depth_at = np.where(den > 0, num / np.maximum(den, 1), 0.0)

    def depth_for_gc(g):
        k = np.searchsorted(gcv, g, side="right") - 1
        return np.where(k >= 0, depth_at[np.clip(k, 0, len(gcv) - 1)],
                        np.nan)

    ys = depth_for_gc(gx)
    fig2, axes = plt.subplots(2, 2, figsize=(10, 7))
    ax = axes[0, 0]
    ax.plot(xs, ys, color=TEAL)
    ax.axhline(1.0, color="red", linestyle=":")
    ax.set_xlim(0, 100)
    ax.set_ylim(0, 1.5)
    ax.set_xlabel("GCPercentile")
    ax.set_ylabel("NormalizedMeanDepth")
    sec = ax.secondary_xaxis(
        "top", functions=(lambda p: np.interp(p, cum, gcv),
                          lambda g: np.interp(g, gcv, cum)))
    sec.set_xlabel("GCPercentage")

    # ---- q7: depth bars from .Summary ----
    summary_rows = _parse_summary(prefix + ".Summary")
    sm = dict(summary_rows)

    def num_of(key, default=0.0):
        v = sm.get(key, "")
        v = v.split("[")[0].strip().rstrip("%")
        try:
            return float(v)
        except ValueError:
            return default

    ax = axes[0, 1]
    names = ["EstimatedQ30Depth", "EstimatedQ20Depth", "EstimatedDepth",
             "ExpectedDepth"]
    vals = [num_of("Q30 Average Actual Depth"),
            num_of("Q20 Average Actual Depth"),
            num_of("Estimated Read Depth"),
            num_of("Expected Read Depth")]
    ax.bar(names, vals, color=TEAL, alpha=0.5)
    ax.set_ylabel("Depth")
    ax.set_title("Depth")
    ax.tick_params(axis="x", labelsize=8, rotation=50)

    # ---- q6: raw + adjusted insert size, 10bp rebinned ----
    adj = _load_table(prefix + ".AdjustedInsertSizeDist")[1:]
    raw = _load_table(prefix + ".RawInsertSizeDist")[1:]
    at = create_den_dist(adj[:, 0], adj[:, 1])
    rt = create_den_dist(raw[:, 0], raw[:, 1])
    at[:, 1] /= at[:, 1].sum() or 1.0
    rt[:, 1] /= rt[:, 1].sum() or 1.0
    lo, hi = find_bump(at[:, 0], at[:, 1])
    ax = axes[1, 0]
    ax.plot(rt[:, 0], rt[:, 1], label="RawInsertSize", color="#F8766D")
    ax.plot(at[:, 0], at[:, 1], label="AdjustedInsertSize", color=TEAL)
    xlo = min(at[lo, 0], 100)
    xhi = max(at[hi, 0], 1000)
    ax.set_xlim(xlo, xhi)
    ax.set_xlabel("InsertSize")
    ax.set_ylabel("Frequency")
    ax.legend(fontsize=6, loc="upper right")
    ax.set_title("InsertSize Distribution")

    # ---- q8: summary fractions bar ----
    ax = axes[1, 1]
    names2 = ["Q20", "Q30", "Depth 1", "Depth 2", "Depth 5", "Depth 10"]
    vals2 = [num_of("Q20 Base Fraction"), num_of("Q30 Base Fraction"),
             num_of("Depth 1 or above position fraction"),
             num_of("Depth 2 or above position fraction"),
             num_of("Depth 5 or above position fraction"),
             num_of("Depth 10 or above position fraction")]
    ax.bar(names2, vals2, color=TEAL, alpha=0.5)
    ax.set_ylabel("Fraction")
    ax.set_title("Summary")
    ax.tick_params(axis="x", rotation=50)
    fig2.tight_layout()
    return fig1, fig2, summary_rows


def _parse_summary(path: str):
    rows = []
    with open(_require(path)) as fh:
        for line in fh:
            if ":" in line:
                k, v = line.split(":", 1)
                rows.append((k.strip(), v.strip()))
    return rows


def _panel_ancestry(prefix: str, svd_prefix: str, pop_path: str, plt):
    """q10 (PC1/PC2) and, with a >=4-PC panel, q11 (PC3/PC4):
    RPlotScript.R:276-333."""
    pops: dict[str, str] = {}
    if pop_path:
        with open(_require(pop_path)) as fh:
            for line in fh:
                p = line.split()
                if len(p) >= 2:
                    pops[p[0]] = p[1]
    ids, coords = [], []
    with open(_require(svd_prefix + ".V")) as fh:
        for line in fh:
            p = line.split()
            if len(p) >= 3:
                ids.append(p[0])
                coords.append([float(x) for x in p[1:5]])
    pc_dim = min(len(c) for c in coords) if coords else 0
    coords = np.array([c[:pc_dim] for c in coords])
    labels = [pops.get(i, "REF") for i in ids]

    target = []
    with open(_require(prefix + ".Ancestry")) as fh:
        fh.readline()
        for line in fh:
            p = line.split()
            if len(p) >= 3:
                target.append(float(p[2]))  # IntendedSample column

    def scatter(ax, cx, cy, title):
        for pop_name in sorted(set(labels)):
            sel = [i for i, l in enumerate(labels) if l == pop_name]
            ax.scatter(coords[sel, cx], coords[sel, cy], s=8, alpha=0.5,
                       color=POP_COLORS.get(pop_name, "#AAAAAA"),
                       label=pop_name)
        if len(target) > cy:
            ax.scatter([target[cx]], [target[cy]], s=60, alpha=0.9,
                       color=POP_COLORS["UserSample"], label="UserSample")
        ax.set_xlabel(f"PC{cx + 1}")
        ax.set_ylabel(f"PC{cy + 1}")
        ax.set_title(title)
        ax.legend(fontsize=5, ncol=2, markerscale=0.7)

    figs = []
    fig, ax = plt.subplots(figsize=(7, 5.5))
    scatter(ax, 0, 1, "Genetic ancestry (PC1 vs PC2)")
    figs.append(fig)
    if pc_dim >= 4:
        fig, ax = plt.subplots(figsize=(7, 5.5))
        scatter(ax, 2, 3, "Genetic ancestry (PC3 vs PC4)")
        figs.append(fig)
    return figs


def generate_report(prefix: str, svd_prefix: str | None = None,
                    pop_path: str | None = None,
                    out_path: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sections: list[str] = []

    # FinalReport.rmd:315-325 - the two CSV tables
    sections.append("<h2 id='fastq'>FASTQ File List</h2>"
                    + _html_table(_read_csv_table(prefix + ".FASTQ.csv"),
                                  "FASTQ List Table"))
    sections.append("<h2 id='prod'>Data Production by FASTQ file</h2>"
                    + _html_table(_read_csv_table(prefix + ".Sequence.csv"),
                                  "Data Production Table"))

    fig1, fig2, summary_rows = _panel_depth_pages(prefix, plt)
    sections.append("<h2 id='depth'>Depth Distribution</h2>"
                    f"<img src='data:image/png;base64,{_fig_to_b64(fig1)}'/>")

    srows = [("Statistics", "Value")] + summary_rows
    sections.append("<h2 id='summary'>Summary Statistics</h2>"
                    + _html_table(srows[:1] + srows[2:],
                                  "Summary Statistics"))
    sections.append("<h2 id='misc'>Summary Plot</h2>"
                    f"<img src='data:image/png;base64,{_fig_to_b64(fig2)}'/>")

    n_panels = 8
    if svd_prefix:
        figs = _panel_ancestry(prefix, svd_prefix, pop_path, plt)
        n_panels += len(figs)
        imgs = "".join(
            f"<img src='data:image/png;base64,{_fig_to_b64(f)}'/>"
            for f in figs)
        sections.append(f"<h2 id='ancestry'>Genetic Ancestry Plot</h2>{imgs}")

    toc = ("<ul>" + "".join(
        f"<li><a href='#{i}'>{t}</a></li>"
        for i, t in [("fastq", "FASTQ File List"),
                     ("prod", "Data Production by FASTQ file"),
                     ("depth", "Depth Distribution"),
                     ("summary", "Summary Statistics"),
                     ("misc", "Summary Plot")]
        + ([("ancestry", "Genetic Ancestry Plot")] if svd_prefix else []))
        + "</ul>")

    html = ["<!DOCTYPE html><html><head><meta charset='utf-8'>",
            "<title>FASTQuick Summary Report</title>",
            "<style>body{font-family:sans-serif;max-width:960px;margin:auto}"
            "table{border-collapse:collapse;margin:1em 0}caption{font-style:"
            "italic;padding:4px}td,th{border:1px solid #ccc;padding:4px 10px}"
            "h2{margin-top:2em}img{max-width:100%}</style></head><body>",
            "<h1>FASTQuick Summary Report</h1>",
            f"<p>Prefix: <code>{os.path.basename(prefix)}</code></p>",
            toc] + sections + ["</body></html>"]

    out = out_path or prefix + ".FinalReport.html"
    with open(out, "w") as fh:
        fh.write("\n".join(html))
    notice("Report written to %s (%d panels)", out, n_panels)
    return out


def run_report(argv: list[str]) -> int:
    pl = ParamList()
    pl.add("in_prefix", "Empty", "prefix of the align/pop+con outputs")
    pl.add("SVDPrefix", "Empty", "SVD prefix (for the ancestry panel)")
    pl.add("PopLabels", "Empty", "sample->population label file (1000g.pop)")
    pl.add("out", "Empty", "output HTML path")
    pl.read(argv)
    if pl["in_prefix"] == "Empty":
        error("--in_prefix is required")
    try:
        generate_report(
            pl["in_prefix"],
            svd_prefix=None if pl["SVDPrefix"] == "Empty" else pl["SVDPrefix"],
            pop_path=None if pl["PopLabels"] == "Empty" else pl["PopLabels"],
            out_path=None if pl["out"] == "Empty" else pl["out"])
    except ReportInputError as exc:
        error("%s", exc)
        return 1
    return 0
