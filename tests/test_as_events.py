"""Legacy event-format handling + count-based two-isoform events."""
import numpy as np

import jax

from miso_jax.core.as_events import (MISOEvents, TwoIsoEvent,
                                     parse_event_information,
                                     se_event_to_gene,
                                     tandem_utr_event_to_gene)
from miso_jax.core.events import pad_events, two_iso_event_from_counts
from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch


def test_parse_se_event_name():
    name = "chr17:100:199:+;chr17:300:349:+;chr17:500:599:+"
    ev = parse_event_information(name, "SE")
    assert ev.chrom == "chr17"
    assert ev.up_part_len == 100
    assert ev.len == 50
    assert ev.dn_part_len == 100


def test_se_event_to_gene():
    g = se_event_to_gene(100, 50, 100, "chr1", label="ev")
    assert g.num_isoforms == 2
    assert g.iso_lengths.tolist() == [250, 200]
    assert [p.label for p in g.parts] == ["A", "B", "C"]


def test_tandem_utr_event_to_gene():
    g = tandem_utr_event_to_gene(200, 100, "chr2")
    assert g.iso_lengths.tolist() == [300, 200]


def test_filter_se_events():
    events = {}
    for i, (ni, ne, nb) in enumerate([(5, 5, 20), (0, 5, 30), (10, 0, 5)]):
        ev = TwoIsoEvent(label="e%d" % i, event_type="SE")
        ev.num_inc, ev.num_exc, ev.num_common = ni, ne, nb
        events[ev.label] = ev
    m = MISOEvents(2, "SE", events=events)
    m.filter_se_events(atleast_inc=1, atleast_exc=1, atleast_sum=20)
    assert sorted(m.events) == ["e0"]


def test_events_to_genes_and_sampler():
    """The reference's legacy two-isoform flow: NI/NE/NB counts -> gene
    -> sampler (miso_sampler.py:469 run_sampler_on_event)."""
    g = se_event_to_gene(100, 50, 100, "chr1", label="ev")
    ev = two_iso_event_from_counts(g, ni=500, ne=50, nb=40, read_len=36)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events([ev]).items()})
    cfg = SamplerConfig(iters=800, burn_in=200, lag=5, chains=2)
    res = run_batch(jax.random.PRNGKey(0), batch, cfg)
    mean = float(np.asarray(res.flat_samples())[0][:, 0].mean())
    # heavy inclusion support -> high psi
    assert mean > 0.75, mean


def test_load_event_counts_se(tmp_path):
    """SE counts file -> events with inc/exc/common summaries
    (as_events.py:420-441)."""
    from miso_jax.core.as_events import load_event_counts
    p = tmp_path / "se_counts.txt"
    p.write_text(
        "chr1:1:100:+;chr1:200:249:+;chr1:300:399:+\t10;5;8;3;4;7\n"
        "chr1:1:50:+;chr1:60:79:+;chr1:90:139:+\t0;0;0;0;0;1\n")
    evs = load_event_counts(str(p), "SE")
    assert len(evs) == 2
    ev = evs.get_event("chr1:1:100:+;chr1:200:249:+;chr1:300:399:+")
    assert ev.num_inc == 5 + 3 + 4
    assert ev.num_exc == 7
    assert ev.num_common == 10 + 8
    evs.filter_events()
    assert len(evs) == 1


def test_load_afe_ale_events(tmp_path):
    """AFE events: structure side-table + 4-count rows + voting filter +
    gene construction (as_events.py:343-504, Gene.py:1086-1127)."""
    from miso_jax.core.as_events import load_event_counts
    info = tmp_path / "afe_info.txt"
    info.write_text(
        "evA\tchr1:100:199:+,chr1:300:349:+\tchr1:500:599:+\n"
        "evB\tchr2:10:59:-\tchr2:100:149:-,chr2:200:219:-\n")
    counts = tmp_path / "afe_counts.txt"
    counts.write_text("evA\t12;8;3;2\nevB\t1;0;1;0\n")
    evs = load_event_counts(str(counts), "AFE",
                            events_info_filename=str(info))
    ev = evs.get_event("evA")
    assert ev.chrom == "chr1"
    assert ev.num_proximal_body == 12 and ev.num_distal_jxns == 2
    assert sum(e["len"] for e in ev.proximal_exons) == 150
    assert sum(e["len"] for e in ev.distal_exons) == 100
    genes = evs.loaded_events_to_genes()
    g = genes["evA"]
    assert g.num_isoforms == 2
    assert sorted(g.iso_lengths.tolist()) == [100, 150]
    evs.filter_events()   # proximal+distal sum >= 20 keeps only evA
    assert list(evs.events) == ["evA"]


def test_load_event_counts_ri_and_tandem(tmp_path):
    from miso_jax.core.as_events import load_event_counts
    ri = tmp_path / "ri.txt"
    ri.write_text("chr1:1:100:+;chr1:101:200:+;chr1:201:300:+\t6;9;4;3\n")
    evs = load_event_counts(str(ri), "RI")
    ev = next(iter(evs.events.values()))
    assert (ev.num_inc, ev.num_exc, ev.num_common) == (9, 3, 10)
    tu = tmp_path / "tu.txt"
    tu.write_text("chr3:1:200:+;chr3:201:300:+\t4;11\n")
    evs = load_event_counts(str(tu), "TandemUTR")
    ev = next(iter(evs.events.values()))
    assert (ev.num_ext, ev.num_core) == (4, 11)
