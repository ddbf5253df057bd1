import numpy as np
import pytest

from miso_jax.core.cigar import CigarError, parse_cigar, parse_cigars


def test_simple_match():
    runs, ln = parse_cigar("36M")
    assert runs == (36,) and ln == 36


def test_junction():
    runs, ln = parse_cigar("10M100N26M")
    assert runs == (10, -100, 26) and ln == 36


def test_insertion_ignored():
    runs, ln = parse_cigar("10M2I26M")
    assert runs == (10, 26) and ln == 36


def test_deletion_counts_as_match():
    runs, ln = parse_cigar("10M2D24M")
    assert runs == (10, 2, 24) and ln == 36


def test_softclip_counts_as_match():
    runs, ln = parse_cigar("4S32M")
    assert runs == (4, 32) and ln == 36


def test_truncation_at_max_read_len():
    # cumulative matched length capped at max_read_len (solve.c:249-253)
    runs, ln = parse_cigar("30M10M", max_read_len=36)
    assert runs == (30, 6) and ln == 36


def test_clip_only_at_ends():
    with pytest.raises(CigarError):
        parse_cigar("10M4S10M")


def test_bad_op():
    with pytest.raises(CigarError):
        parse_cigar("10M5P10M")


def test_parse_many():
    runs, off, lens = parse_cigars(["36M", "10M50N26M"])
    assert list(runs) == [36, 10, -50, 26]
    assert list(off) == [0, 1, 4]
    assert list(lens) == [36, 36]
