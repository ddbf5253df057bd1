"""Live reference-engine oracle: build and drive the UNMODIFIED
reference MISO C engine (libsplicing) for statistical-parity tests.

The acceptance criterion (ROADMAP.md) is that miso_jax matches
reference MISO on the shipped test data.  The shipped `.miso` fixtures
under sashimi_plot/test-data/miso-data were generated by the pre-fastmiso
Python sampler (iters=2000/burn_in=200/lag=5 are not the modern defaults,
and their posteriors deviate from the current C engine's by up to 0.08 --
see docs/PARITY.md), so the sharp oracle is the reference's OWN C engine
compiled from /root/reference/pysplicing and run on identical reads.

Build notes: every reference source compiles unmodified except
src/random.c, whose file-local static fallbacks (expm1/rint/rintf) clash
with the C99 libc prototypes under a modern glibc; those three statics
are renamed in a throwaway copy (pure symbol rename, no behavior change).
Objects are prefixed core_/lapack_/f2c_ because src/util.c and
src/f2c/util.c share a basename.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REF = "/root/reference/pysplicing"
_DRIVER_SRC = os.path.join(os.path.dirname(__file__), "ref_driver.c")


def _build_dir() -> str:
    return os.environ.get(
        "MISO_REFBUILD_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "miso_jax",
                     "refbuild"))


def build_ref_driver() -> Optional[str]:
    """Compile libsplicing + the parity driver; returns driver path or
    None when the reference tree / toolchain is unavailable."""
    if not os.path.isdir(REF):
        return None
    bdir = _build_dir()
    driver = os.path.join(bdir, "ref_driver")
    stamp = os.path.join(bdir, ".stamp")
    src_mtime = str(os.path.getmtime(_DRIVER_SRC))
    if os.path.exists(driver) and os.path.exists(stamp):
        if open(stamp).read() == src_mtime:
            return driver
    os.makedirs(bdir, exist_ok=True)

    def run(cmd, **kw):
        return subprocess.run(cmd, capture_output=True, text=True, **kw)

    if run(["gcc", "--version"]).returncode != 0:
        return None

    objs: List[str] = []

    def cc(src: str, obj: str, extra_inc: Sequence[str] = ()) -> bool:
        out = os.path.join(bdir, obj)
        cmd = ["gcc", "-c", "-O2", "-fPIC", "-w",
               "-I", os.path.join(REF, "include"),
               "-I", os.path.join(REF, "src")]
        for inc in extra_inc:
            cmd += ["-I", inc]
        cmd += ["-o", out, src]
        if run(cmd).returncode != 0:
            return False
        objs.append(out)
        return True

    import re

    for f in sorted(os.listdir(os.path.join(REF, "src"))):
        if not f.endswith(".c"):
            continue
        base = f[:-2]
        if base in ("pysplicing", "pyconvert", "pyerror", "pyrandom"):
            continue  # CPython glue: not needed, needs Python2 headers
        src = os.path.join(REF, "src", f)
        if base == "random":
            # rename the three file-local statics that collide with
            # modern libc prototypes (declaration-only conflict)
            txt = open(src).read()
            txt = re.sub(r"\b(expm1|rint|rintf)\b", r"splx_\1", txt)
            src = os.path.join(bdir, "random_patched.c")
            with open(src, "w") as fh:
                fh.write(txt)
        if not cc(src, "core_%s.o" % base):
            return None
    for sub in ("lapack", "f2c"):
        d = os.path.join(REF, "src", sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".c"):
                cc(os.path.join(d, f), "%s_%s.o" % (sub, f[:-2]),
                   extra_inc=[d])

    lib = os.path.join(bdir, "libsplicing.so")
    if run(["gcc", "-shared", "-o", lib] + objs + ["-lm"]).returncode != 0:
        return None
    r = run(["gcc", "-O2", "-I", os.path.join(REF, "include"),
             "-I", os.path.join(REF, "src"), "-o", driver, _DRIVER_SRC,
             "-L", bdir, "-lsplicing", "-lm", "-Wl,-rpath," + bdir])
    if r.returncode != 0:
        return None
    with open(stamp, "w") as fh:
        fh.write(src_mtime)
    return driver


class RefResult:
    def __init__(self, samples: np.ndarray, loglik: np.ndarray,
                 classes: List[Tuple[Tuple[int, ...], int]],
                 assigned: List[int], accepted: int, rejected: int):
        self.samples = samples      # (S, I)
        self.loglik = loglik        # (S,)
        self.classes = classes
        self.assigned = assigned
        self.accepted = accepted
        self.rejected = rejected

    @property
    def counts_str(self) -> str:
        return ",".join("%s:%d" % (str(t).replace(" ", ""), c)
                        for t, c in self.classes)


def run_ref_miso(
    driver: str,
    gff_path: str,
    positions: Sequence[int],
    cigars: Sequence[str],
    gene_idx: int = 0,
    read_len: int = 48,
    overhang: int = 1,
    chains: int = 6,
    iters: int = 5000,
    burn_in: int = 500,
    lag: int = 10,
    algorithm: int = 0,
    seed: int = 42,
    paired: Optional[Dict[str, float]] = None,
) -> RefResult:
    """Run the reference engine; positions are 1-based (the driver feeds
    them to splicing_miso exactly as misopy/miso_sampler.py:284 does)."""
    args = [driver, gff_path, str(gene_idx), str(read_len), str(overhang),
            str(chains), str(iters), str(burn_in), str(lag),
            str(algorithm), str(seed)]
    if paired is not None:
        args += [str(paired["mean"]), str(paired["sd"]),
                 str(int(paired.get("num_devs", 4)))]
    stdin = "".join("%d\t%s\n" % (p, c) for p, c in zip(positions, cigars))
    r = subprocess.run(args, input=stdin, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError("ref_driver failed: %s" % r.stderr[-500:])
    samples: List[List[float]] = []
    loglik: List[float] = []
    classes: List[Tuple[Tuple[int, ...], int]] = []
    assigned: List[int] = []
    accepted = rejected = 0
    for line in r.stdout.splitlines():
        parts = line.split("\t")
        if parts[0] == "sample":
            samples.append([float(x) for x in parts[1].split(",")])
            loglik.append(float(parts[2]))
        elif parts[0] == "class":
            classes.append((tuple(int(x) for x in parts[1].split(",")),
                            int(parts[2])))
        elif parts[0] == "assigned":
            assigned = [int(x) for x in parts[1:]]
        elif parts[0] == "accepted":
            accepted, rejected = int(parts[1]), int(parts[2])
    return RefResult(np.asarray(samples), np.asarray(loglik), classes,
                     assigned, accepted, rejected)
