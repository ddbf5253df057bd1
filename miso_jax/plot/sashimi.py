"""Sashimi plots: per-sample read densities with junction arcs, an mRNA
diagram track, and MISO posterior panels.

Capability parity with misopy/sashimi_plot/** (plot_gene.py:22-171 read
densities + junction bezier arcs, :366-391 strand-aware coordinate
scaling, :286-360 shared-ymax axis normalization, :492-527 mRNA diagrams
with intron arrows, :533-648 posterior panels incl. bar_posteriors;
sashimi_plot.py CLI modes --plot-event / --plot-insert-len /
--plot-bf-dist), rendered with matplotlib over the native BAM reader.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.path import Path as MplPath
from matplotlib.patches import PathPatch

from miso_jax.plot.settings import parse_plot_settings


# ------------------------------------------------------------- densities

def reads_to_wiggle(reads, start: int, end: int
                    ) -> Tuple[np.ndarray, Dict[Tuple[int, int], int]]:
    """Per-bp read density over [start, end] (1-based inclusive) plus
    junction span counts.  Each aligned base contributes 1/read_length so
    one full read sums to ~1 (parity: plot_gene.py:405-444
    readsToWiggle_pysam, wiggle[idx] += 1./read.qlen).  Junction keys are
    (last exonic bp, first exonic bp after the gap), both 1-based."""
    depth = np.zeros(end - start + 1, dtype=np.float64)
    junctions: Dict[Tuple[int, int], int] = {}
    for read in reads:
        if read.cigar is None:
            continue
        # query-alignment length for the 1/qlen weight: pysam read.qlen
        # counts query-consuming aligned ops (M/I/=/X, not soft clips)
        qlen = 0
        num = ""
        for ch in read.cigar_str:
            if ch.isdigit():
                num += ch
            else:
                if ch in "MI=X":
                    qlen += int(num)
                num = ""
        if qlen == 0:
            continue
        w = 1.0 / qlen
        pos = read.pos + 1  # 1-based
        num = ""
        for ch in read.cigar_str:
            if ch.isdigit():
                num += ch
                continue
            ln = int(num)
            num = ""
            if ch in "M=X":
                lo = max(pos, start)
                hi = min(pos + ln - 1, end)
                if hi >= lo:
                    depth[lo - start:hi - start + 1] += w
                pos += ln
            elif ch in "DN":
                if ch == "N":
                    j = (pos - 1, pos + ln)  # last exonic bp, next exonic bp
                    if start < j[0] < end and start < j[1] < end:
                        junctions[j] = junctions.get(j, 0) + 1
                pos += ln
            # I/S/H consume no reference
    return depth, junctions


# ------------------------------------------------- coordinate compression

class GenomeTransform:
    """Piecewise-linear genomic -> plot coordinate map that shrinks
    introns (intron_scale) and exons (exon_scale), the sashimi look.
    With reverse=True the axis runs right-to-left (minus-strand events
    under reverse_minus=False; parity plot_gene.py:379-390)."""

    def __init__(self, exon_union: List[Tuple[int, int]], start: int,
                 end: int, intron_scale: float, exon_scale: float,
                 reverse: bool = False):
        # build segments covering [start, end]
        segs = []
        cur = start
        for (s, e) in sorted(exon_union):
            s, e = max(s, start), min(e, end)
            if s > cur:
                segs.append((cur, s - 1, 1.0 / intron_scale))
            if e >= s:
                segs.append((s, e, 1.0 / exon_scale))
                cur = e + 1
        if cur <= end:
            segs.append((cur, end, 1.0 / intron_scale))
        self.segs = segs
        self.breaks = np.array([s[0] for s in segs] + [end + 1])
        starts_out = [0.0]
        for (s, e, f) in segs:
            starts_out.append(starts_out[-1] + (e - s + 1) * f)
        self.out_starts = np.array(starts_out)
        self.total = starts_out[-1]
        self.reverse = reverse
        self.start, self.end = start, end

    def __call__(self, pos):
        pos = np.asarray(pos, dtype=np.float64)
        idx = np.clip(np.searchsorted(self.breaks, pos, side="right") - 1,
                      0, len(self.segs) - 1)
        seg_start = self.breaks[idx]
        factors = np.array([s[2] for s in self.segs])[idx]
        out = self.out_starts[idx] + (pos - seg_start) * factors
        return self.total - out if self.reverse else out

    def inverse(self, x: float) -> int:
        """Plot coordinate -> genomic coordinate (parity: graphToGene,
        plot_gene.py:374)."""
        if self.reverse:
            x = self.total - x
        i = int(np.clip(np.searchsorted(self.out_starts, x, side="right")
                        - 1, 0, len(self.segs) - 1))
        s, _, f = self.segs[i]
        return int(round(s + (x - self.out_starts[i]) / f))


# ------------------------------------------------------------- plotting

def _junction_num_isoforms(gene, j_lo: int, j_hi: int) -> int:
    """How many isoforms contain both splice sites of a junction
    (parity: plot_gene.py:106-112 sslists membership)."""
    n = 0
    for i in range(gene.num_isoforms):
        starts, ends = gene.iso_exons(i)
        sites = set(int(v) for v in starts) | set(int(v) for v in ends)
        if j_lo in sites and j_hi in sites:
            n += 1
    return n


def _cubic_bezier(pts, t):
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float64) for p in pts)
    return (p0 * (1 - t) ** 3 + 3 * t * p1 * (1 - t) ** 2
            + 3 * t ** 2 * (1 - t) * p2 + t ** 3 * p3)


def _plot_density_axis(ax, depth, junctions, tx, start, end, color,
                       gene, settings):
    """One sample's density + junction arcs.  Leaves y-limits provisional
    (1.1 * max height); plot_event() then normalizes all samples to a
    shared ymax (parity: plot_gene.py:22-171 plot_density_single)."""
    logged = settings.get("logged", False)
    if logged:
        depth = np.log10(depth + 1)
    maxheight = float(depth.max()) if depth.size else 0.0
    ymax = 1.1 * maxheight if maxheight > 0 else 1.0
    ymin = -0.5 * ymax

    # resolution-compressed fill (plot_gene.py:77-92): average the wiggle
    # within plot-x bins of width `resolution`
    xs = np.asarray(tx(np.arange(start, end + 1)))
    order = np.argsort(xs, kind="stable")
    xs_s, depth_s = xs[order], depth[order]
    resolution = float(settings.get("resolution", 0.5))
    nbins = max(int(tx.total / max(resolution, 1e-9)) + 1, 1)
    bins = np.clip((xs_s / max(resolution, 1e-9)).astype(int), 0, nbins - 1)
    sums = np.bincount(bins, weights=depth_s, minlength=nbins)
    cnts = np.bincount(bins, minlength=nbins)
    mask = cnts > 0
    comp_x = (np.arange(nbins)[mask] + 0.5) * resolution
    comp_w = sums[mask] / cnts[mask]
    ax.fill_between(comp_x, comp_w, y2=0, color=color, linewidth=0)

    # junction arcs: odd isoform-membership on top, even below the axis
    # (plot_gene.py:101-133); linewidth log-scaled by count
    jlb = float(settings.get("junction_log_base", 10.0))
    font_size = settings.get("font_size", 6)
    h = -3 * ymin / 4
    for (j_lo, j_hi), count in sorted(junctions.items()):
        x1, x2 = float(tx(j_lo)), float(tx(j_hi))
        niso = _junction_num_isoforms(gene, j_lo, j_hi)
        if niso <= 0:
            niso = 1  # junction absent from the annotation: draw on top
        if niso % 2 == 0:
            pts = [(x1, 0.0), (x1, -h), (x2, -h), (x2, 0.0)]
        else:
            d1 = depth[min(max(j_lo - start, 0), len(depth) - 1)]
            d2 = depth[min(max(j_hi - start, 0), len(depth) - 1)]
            pts = [(x1, d1), (x1, d1 + h), (x2, d2 + h), (x2, d2)]
        midpt = _cubic_bezier(pts, 0.5)
        path = MplPath(pts, [MplPath.MOVETO, MplPath.CURVE4,
                             MplPath.CURVE4, MplPath.CURVE4])
        lw = math.log(count + 1) / math.log(jlb) if jlb > 1 else 0.8
        ax.add_patch(PathPatch(path, fill=False, edgecolor=color,
                               linewidth=lw))
        if settings.get("number_junctions", True):
            ax.text(midpt[0], midpt[1], str(count), fontsize=font_size,
                    ha="center", va="center", backgroundcolor="w")

    ax.set_ylim(ymin, ymax)
    ax.set_xlim(0, tx.total)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.tick_params(labelsize=font_size)


def _finalize_density_axes(axes, tx, gene, settings, sample_labels,
                           colors):
    """Shared-ymax normalization across sample axes + universal yticks,
    sample labels, RPKM ylabel, genomic-coordinate xticks (parity:
    plot_gene.py:286-360)."""
    font_size = settings.get("font_size", 6)
    nyticks = int(settings.get("nyticks", 3))
    nxticks = int(settings.get("nxticks", 4))
    logged = settings.get("logged", False)

    ymax_setting = settings.get("ymax")
    if ymax_setting is not None:
        max_y = float(ymax_setting)
    else:
        max_y = math.ceil(max(ax.get_ylim()[1] for ax in axes))
    fake_ymin = -0.6 * max_y
    universal_yticks = np.linspace(0, max_y, nyticks + 1)

    ylabels = []
    for y in universal_yticks:
        if y <= 0:
            ylabels.append("")  # the 0 label is suppressed
        elif y % 1 != 0:
            ylabels.append("%.1f" % y)
        else:
            ylabels.append("%d" % y)

    for i, ax in enumerate(axes):
        ax.set_ylim(fake_ymin, max_y)
        ax.set_yticks(universal_yticks)
        ax.set_yticklabels(ylabels, fontsize=font_size)
        ax.spines["left"].set_bounds(0, max_y)
        ax.yaxis.set_ticks_position("left")
        if settings.get("show_ylabel", True):
            ax.set_ylabel(
                "RPKM $(\\mathregular{\\log}_{\\mathregular{10}})$"
                if logged else "RPKM",
                fontsize=font_size, ha="left",
                va="bottom" if not logged else "center")
        # sample label between the two highest yticks, right-aligned
        if len(universal_yticks) >= 2:
            label_y = (universal_yticks[-2]
                       + (universal_yticks[-1] - universal_yticks[-2]) / 2)
        else:
            label_y = universal_yticks[-1]
        ax.text(tx.total, label_y, str(sample_labels[i]),
                fontsize=font_size, va="bottom", ha="right",
                color=colors[i % len(colors)])
        if i < len(axes) - 1:
            ax.set_xticks([])
            ax.spines["bottom"].set_visible(False)
        else:
            xticks = np.linspace(0, tx.total, nxticks)
            ax.set_xticks(xticks)
            ax.set_xticklabels(
                [str(tx.inverse(float(x))) for x in xticks],
                fontsize=font_size * 0.8)
            if settings.get("show_xlabel", True):
                ax.set_xlabel(
                    'Genomic coordinate (%s), "%s" strand'
                    % (gene.chrom, gene.strand or "+"),
                    fontsize=font_size)


def _plot_mrna_axis(ax, gene, tx, settings):
    """mRNA diagram track with intron direction arrows (parity:
    plot_gene.py:492-527 plot_mRNAs)."""
    n = gene.num_isoforms
    font_size = settings.get("font_size", 6)
    exonwidth = 0.3
    narrows = 50
    strand = gene.strand or "+"
    reverse_minus = settings.get("reverse_minus", False)
    # arrows point rightward unless the axis shows an un-reversed minus
    # strand (plot_gene.py:516-520: '+' or reverse_minus -> rightward)
    rightward = (strand == "+") or reverse_minus
    spread = 0.2 * tx.total / narrows
    for i in range(n):
        y = float(i)
        starts, ends = gene.iso_exons(i)
        for s, e in zip(starts, ends):
            x1, x2 = sorted((float(tx(s)), float(tx(e))))
            ax.fill_between([x1, x2], y - exonwidth / 2, y + exonwidth / 2,
                            color="k", linewidth=0.5, zorder=20)
        ax.axhline(y, color="k", linewidth=0.5)
        for a in range(narrows):
            loc = a * tx.total / narrows
            if rightward:
                xa = [loc - spread, loc, loc - spread]
            else:
                xa = [loc + spread, loc, loc + spread]
            ya = [y - exonwidth / 5, y, y + exonwidth / 5]
            ax.plot(xa, ya, lw=0.5, color="k")
        ax.text(-0.01 * tx.total, y, gene.iso_desc_str(i)[:24],
                fontsize=font_size, ha="right", va="center")
    ax.set_xlim(0, tx.total)
    ax.set_ylim(-0.5, n + 0.5)
    ax.axis("off")


def _plot_posterior_axis(ax, samples, settings, show_x_axis=True):
    """Posterior distribution panel: Psi histogram (or bar_posteriors
    errorbar) with 95% CI markers (parity: plot_gene.py:533-648
    plot_posterior_single)."""
    from miso_jax.stats.intervals import compute_credible_intervals
    psi = samples[:, 0]
    font_size = settings.get("font_size", 6)
    mean = float(psi.mean())
    lo, hi = compute_credible_intervals(psi.copy())
    if settings.get("bar_posteriors", False):
        ax.errorbar([mean], [1], xerr=[[mean - lo], [hi - mean]],
                    fmt="o", ms=4, ecolor="k", markerfacecolor="#ffffff",
                    markeredgecolor="k")
        ax.text(1, 1, "$\\Psi$ = %.2f\n[%.2f, %.2f]" % (mean, lo, hi),
                fontsize=font_size, va="top", ha="left")
        ax.set_yticks([])
    else:
        bins = int(settings.get("posterior_bins", 40))
        y, _, _ = ax.hist(psi, np.linspace(0, 1, bins), density=True,
                          facecolor="k", edgecolor="w", linewidth=0.2)
        ymax = float(np.max(y)) * 1.5 if len(y) else 1.0
        ax.axvline(lo, ymin=0.33, linestyle="--", dashes=(1, 1),
                   color="#CCCCCC", linewidth=0.5)
        ax.axvline(hi, ymin=0.33, linestyle="--", dashes=(1, 1),
                   color="#CCCCCC", linewidth=0.5)
        ax.axvline(mean, ymin=0.33, color="r")
        ax.text(1, ymax, "$\\Psi$ = %.2f\n[%.2f, %.2f]" % (mean, lo, hi),
                fontsize=font_size, va="top", ha="left")
        ax.set_ylim(-0.5 * ymax, ymax)
        ax.spines["left"].set_bounds(0, ymax)
        nyticks = 4
        ax.set_yticks(np.linspace(0, ymax, nyticks))
        ax.set_yticklabels(["%d" % v for v in np.linspace(0, ymax, nyticks)],
                           fontsize=font_size)
        ax.yaxis.set_ticks_position("left")
    ax.set_xlim(0, 1)
    ax.set_xticks([0, 0.2, 0.4, 0.6, 0.8, 1])
    ax.tick_params(labelsize=font_size * 0.7)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.spines["bottom"].set_position(("data", 0))
    ax.xaxis.set_ticks_position("bottom")
    if show_x_axis:
        ax.set_xlabel("MISO $\\Psi$", fontsize=font_size)
    else:
        for label in ax.get_xticklabels():
            label.set_visible(False)


def plot_event(event_name: str, index_dir: str, settings_filename: str,
               output_dir: str, no_posteriors: bool = False,
               plot_title: Optional[str] = None,
               plot_label: Optional[str] = None,
               return_figure: bool = False):
    """--plot-event: densities + arcs per sample, mRNA track, posteriors.
    Ref: misopy/sashimi_plot/sashimi_plot.py:108-154.

    return_figure=True also returns the (open) matplotlib Figure so the
    golden-structure regression test can assert axis ranges, arc
    counts, and tick order (tests/test_sashimi_golden.py)."""
    from miso_jax.io.index import get_gene_ids_to_filenames, load_indexed_gene
    from miso_jax.io.miso_file import MISOSamples
    from miso_jax.io.sam import fetch_bam_reads_in_gene, open_alignments

    settings = parse_plot_settings(settings_filename)
    id_to_fname = get_gene_ids_to_filenames(index_dir)
    if event_name not in id_to_fname:
        raise KeyError("Event %s not found in index %s"
                       % (event_name, index_dir))
    gene = load_indexed_gene(id_to_fname[event_name])[event_name][
        "gene_object"]
    start, end = gene.genomic_span()
    exon_union = [(p.start, p.end) for p in gene.parts]
    # minus-strand events read right-to-left unless reverse_minus flips
    # them to the plus orientation (plot_gene.py:379: reversal when
    # strand == '-' and not reverse_minus)
    reverse = (gene.strand == "-"
               and not settings.get("reverse_minus", False))
    tx = GenomeTransform(exon_union, start, end,
                         settings.get("intron_scale", 30.0),
                         settings.get("exon_scale", 4.0),
                         reverse=reverse)

    bam_files = settings.get("bam_files", [])
    miso_files = settings.get("miso_files", [])
    colors = settings.get("colors") or ["#CC0011"] * max(len(bam_files), 1)
    show_posteriors = settings.get("show_posteriors", True) and \
        not no_posteriors
    n_samples = len(bam_files)
    gp_ratio = settings.get("gene_posterior_ratio", 5)

    fig_w = settings.get("fig_width", 7.0)
    fig_h = settings.get("fig_height", 5.0)
    nrows = n_samples + 1
    ncols = 2 if show_posteriors else 1
    width_ratios = [gp_ratio, 1] if show_posteriors else [1]
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(fig_w, fig_h), squeeze=False,
        gridspec_kw={"width_ratios": width_ratios,
                     "height_ratios": [1] * n_samples + [0.8]})

    sample_labels = (settings.get("sample_labels") or miso_files
                     or bam_files)
    density_axes = []
    for i, bam in enumerate(bam_files):
        bam_path = os.path.join(settings.get("bam_prefix", ""), bam)
        alignments = open_alignments(bam_path)
        reads = fetch_bam_reads_in_gene(alignments, gene.chrom,
                                        start - 1, end)
        depth, junctions = reads_to_wiggle(reads, start, end)
        # RPKM-style normalization (plot_gene.py:57: 1e3 * wiggle / coverage)
        cov = (settings.get("coverages") or [None] * n_samples)[i]
        depth = 1e3 * depth / cov if cov else depth
        _plot_density_axis(axes[i][0], depth, junctions, tx, start, end,
                           colors[i % len(colors)], gene, settings)
        density_axes.append(axes[i][0])
        if show_posteriors:
            ax_post = axes[i][1]
            miso_dir = os.path.join(settings.get("miso_prefix", ""),
                                    str(miso_files[i]))
            try:
                data = MISOSamples(miso_dir).get_event_samples(event_name)
            except Exception:
                data = None
            if data is not None:
                _plot_posterior_axis(ax_post, data.samples, settings,
                                     show_x_axis=(i == n_samples - 1))
            else:
                ax_post.axis("off")

    _finalize_density_axes(density_axes, tx, gene, settings,
                           sample_labels, colors)
    _plot_mrna_axis(axes[n_samples][0], gene, tx, settings)
    if show_posteriors:
        axes[n_samples][1].axis("off")

    fig.suptitle(plot_title or event_name,
                 fontsize=settings.get("font_size", 6) + 4)
    fig.subplots_adjust(hspace=0.10, wspace=0.7)
    out_name = (plot_label or event_name).replace("/", "_") + ".pdf"
    out_path = os.path.join(output_dir, out_name)
    fig.savefig(out_path, bbox_inches="tight")
    print("Saved plot to %s" % out_path)
    if return_figure:
        return out_path, fig
    plt.close(fig)
    return out_path


def plot_insert_len(insert_len_filename: str, settings_filename: str,
                    output_dir: str) -> str:
    """--plot-insert-len: histogram of the insert length distribution.
    Ref: sashimi_plot.py:156-204."""
    settings = parse_plot_settings(settings_filename)
    from miso_jax.cli.pe_utils import parse_insert_len_params
    lengths: List[int] = []
    with open(insert_len_filename) as f:
        params = parse_insert_len_params(f.readline())
        for line in f:
            fields = line.strip().split("\t")
            if len(fields) == 2:
                lengths.extend(int(x) for x in fields[1].split(","))
    fig, ax = plt.subplots(figsize=(settings.get("fig_width", 7),
                                    settings.get("fig_height", 5)))
    ax.hist(lengths, bins=50, color=settings.get("bar_color", "b"))
    ax.set_xlabel("Insert length (nt)")
    ax.set_ylabel("No. read pairs")
    ax.set_title("mean=%s sdev=%s dispersion=%s"
                 % (params.get("mean"), params.get("sdev"),
                    params.get("dispersion")))
    out_path = os.path.join(
        output_dir,
        os.path.basename(insert_len_filename) + ".pdf")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print("Saved plot to %s" % out_path)
    return out_path


def plot_bf_dist(bf_filename: str, settings_filename: str,
                 output_dir: str, max_bf: float = 1e12) -> str:
    """--plot-bf-dist: events passing each Bayes-factor threshold.
    Ref: sashimi_plot.py:35-106."""
    settings = parse_plot_settings(settings_filename)
    thresholds = settings.get("bf_thresholds", [0, 1, 2, 5, 10, 20])
    from miso_jax.cli.filter_events import read_bf_file
    _, rows = read_bf_file(bf_filename)
    bfs = np.array([
        min(float(r["bayes_factor"].split(",")[0]), max_bf) for r in rows])
    counts = [(bfs >= t).sum() for t in thresholds]
    fig, ax = plt.subplots(figsize=(settings.get("fig_width", 7),
                                    settings.get("fig_height", 5)))
    ax.bar(range(len(thresholds)), counts,
           color=settings.get("bar_color", "b"))
    ax.set_xticks(range(len(thresholds)))
    ax.set_xticklabels([">= %g" % t for t in thresholds])
    ax.set_xlabel("Bayes factor threshold")
    ax.set_ylabel("No. events")
    out_path = os.path.join(output_dir,
                            os.path.basename(bf_filename) + ".pdf")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print("Saved plot to %s" % out_path)
    return out_path
