"""Sashimi golden-structure regression: the rendered figure's STRUCTURE
(axis ranges, junction-arc counts, reversed-axis tick order, shared
ymax, posterior panel count) is pinned, not just "a file was written".
Regressions in GenomeTransform / arc placement / axis finalization fail
here.  Ref: misopy/sashimi_plot/plot_utils/plot_gene.py:22-360.
"""
import os

import numpy as np
import pytest

import matplotlib
matplotlib.use("Agg")

SASHIMI_DATA = "/root/reference/misopy/sashimi_plot/test-data"
EVENTS_GFF = os.path.join(SASHIMI_DATA, "events.gff")
MISO_DATA = os.path.join(SASHIMI_DATA, "miso-data")
EVENT = ("chr17:45816186:45816265:-@chr17:45815912:45815950:-"
         "@chr17:45814875:45814965:-")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(SASHIMI_DATA), reason="reference test-data missing")

SETTINGS_TMPL = """\
[data]
bam_prefix = %s
miso_prefix = %s
bam_files = ["heartWT1.sorted.bam", "heartKOa.sorted.bam"]
miso_files = ["heartWT1", "heartKOa"]

[plotting]
fig_width = 7
fig_height = 5
intron_scale = 30
exon_scale = 4
colors = ["#CC0011", "#FF8800"]
number_junctions = True
%s
"""


@pytest.fixture(scope="module")
def events_index(tmp_path_factory):
    from miso_jax.io.index import index_gff
    out = str(tmp_path_factory.mktemp("golden_index"))
    assert index_gff(EVENTS_GFF, out)
    return out


def _render(events_index, tmp_path, extra=""):
    from miso_jax.plot.sashimi import plot_event
    p = tmp_path / "settings.txt"
    p.write_text(SETTINGS_TMPL
                 % (os.path.join(SASHIMI_DATA, "bam-data"), MISO_DATA,
                    extra))
    out, fig = plot_event(EVENT, events_index, str(p), str(tmp_path),
                          return_figure=True)
    assert os.path.isfile(out)
    return fig


def _expected_junctions(sample):
    from miso_jax.io.gff import load_genes_from_gff
    from miso_jax.io.sam import fetch_bam_reads_in_gene, open_alignments
    from miso_jax.plot.sashimi import reads_to_wiggle
    genes = load_genes_from_gff(EVENTS_GFF)
    (_, gene), = genes.items()
    lo, hi = gene.genomic_span()
    bam = open_alignments(os.path.join(
        SASHIMI_DATA, "bam-data", "%s.sorted.bam" % sample))
    reads = fetch_bam_reads_in_gene(bam, gene.chrom, lo - 1, hi)
    _, junctions = reads_to_wiggle(reads, lo, hi)
    return junctions


def test_structure_minus_strand(events_index, tmp_path):
    import matplotlib.pyplot as plt
    from matplotlib.patches import PathPatch

    fig = _render(events_index, tmp_path)
    try:
        axes = fig.axes
        # 2 samples x (density, posterior) + (mRNA, blank) = 6 axes
        assert len(axes) == 6
        density = [axes[0], axes[2]]
        # density axes share the exact transform-length x-range
        x0, x1 = density[0].get_xlim()
        assert x0 == 0 and x1 > 0
        assert density[1].get_xlim() == density[0].get_xlim()
        # shared ymax across samples (plot_gene.py:286-311)
        assert density[0].get_ylim() == density[1].get_ylim()
        # junction arcs: one PathPatch per observed junction
        for ax, sample in zip(density, ("heartWT1", "heartKOa")):
            arcs = [p for p in ax.patches if isinstance(p, PathPatch)]
            assert len(arcs) == len(_expected_junctions(sample))
        # minus-strand event, reverse_minus unset: genomic coordinates
        # must DECREASE left to right (plot_gene.py:379)
        last_density = axes[2]
        labels = [int(t.get_text())
                  for t in last_density.get_xticklabels() if t.get_text()]
        assert len(labels) >= 2 and labels == sorted(labels, reverse=True)
        # tick extremes map back into the event's genomic span
        assert 45814875 - 2 <= min(labels) <= max(labels) <= 45816265 + 2
        # posterior panels: both samples rendered with content
        for ax_post in (axes[1], axes[3]):
            assert (len(ax_post.lines) + len(ax_post.patches)) > 0
    finally:
        plt.close(fig)


def test_structure_reverse_minus_flips_axis(events_index, tmp_path):
    import matplotlib.pyplot as plt

    fig = _render(events_index, tmp_path, "reverse_minus = True")
    try:
        last_density = fig.axes[2]
        labels = [int(t.get_text())
                  for t in last_density.get_xticklabels() if t.get_text()]
        assert len(labels) >= 2 and labels == sorted(labels)
    finally:
        plt.close(fig)


def test_structure_fixed_ymax_and_bar_posteriors(events_index, tmp_path):
    import matplotlib.pyplot as plt

    fig = _render(events_index, tmp_path,
                  "ymax = 3\nbar_posteriors = True\nnyticks = 3")
    try:
        density = [fig.axes[0], fig.axes[2]]
        for ax in density:
            assert ax.get_ylim()[1] == 3.0
            ticks = [t for t in ax.get_yticks() if 0 <= t <= 3.0]
            assert max(ticks) == 3.0
    finally:
        plt.close(fig)


def test_structure_all_four_shipped_samples(events_index, tmp_path):
    """The full shipped dataset (setup.py:128-153): all 4 real heart
    BAMs + their reference-produced .miso posteriors on the shipped
    minus-strand event.  Asserts per-sample structure: junction-arc
    counts from each BAM, one posterior panel per sample with content,
    shared density ymax across all four tracks."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import PathPatch

    from miso_jax.plot.sashimi import plot_event

    samples = ["heartWT1", "heartWT2", "heartKOa", "heartKOb"]
    p = tmp_path / "settings4.txt"
    p.write_text("""\
[data]
bam_prefix = %s
miso_prefix = %s
bam_files = [%s]
miso_files = [%s]

[plotting]
fig_width = 7
fig_height = 8
intron_scale = 30
exon_scale = 4
colors = ["#CC0011", "#FF8800", "#0080FF", "#229922"]
show_posteriors = True
""" % (os.path.join(SASHIMI_DATA, "bam-data"), MISO_DATA,
       ",".join('"%s.sorted.bam"' % s for s in samples),
       ",".join('"%s"' % s for s in samples)))
    out, fig = plot_event(EVENT, events_index, str(p), str(tmp_path),
                          return_figure=True)
    assert os.path.isfile(out)
    try:
        axes = fig.axes
        # 4 samples x (density, posterior) + (mRNA, blank) = 10 axes
        assert len(axes) == 10
        density = [axes[2 * i] for i in range(4)]
        posteriors = [axes[2 * i + 1] for i in range(4)]
        ylims = {ax.get_ylim() for ax in density}
        assert len(ylims) == 1  # shared ymax (plot_gene.py:286-311)
        for ax, sample in zip(density, samples):
            arcs = [q for q in ax.patches if isinstance(q, PathPatch)]
            assert len(arcs) == len(_expected_junctions(sample)), sample
        for ax_post in posteriors:
            assert (len(ax_post.lines) + len(ax_post.patches)) > 0
    finally:
        plt.close(fig)
