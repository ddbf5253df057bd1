"""SQLite packing of per-chromosome `.miso` directories into `.miso_db`.

Format parity: misopy/miso_db.py -- table `table_<chrom>` with columns
(event_name text, psi_vals_and_scores text, header text); the header column
holds the two header lines, the data column the sample lines.
"""
from __future__ import annotations

import fnmatch
import glob
import io
import os
import sqlite3
import sys
from typing import Dict, List, Optional

MISO_DB_EXT = ".miso_db"


def is_miso_db_fname(fname: str) -> bool:
    return fname.endswith(MISO_DB_EXT)


def strip_miso_ext(filename: str) -> str:
    return filename[:-5] if filename.endswith(".miso") else filename


def get_table_name_from_file(db_filename: str) -> Optional[str]:
    base = os.path.basename(db_filename)
    if base.endswith(MISO_DB_EXT):
        return base[: -len(MISO_DB_EXT)]
    return None


def is_miso_unpacked_dir(dirname: str) -> bool:
    if not os.path.isdir(dirname):
        return False
    return len(fnmatch.filter(os.listdir(dirname), "*.miso")) != 0


class MISODatabase:
    """Read access to one `.miso_db` file (misopy/miso_db.py:23-141)."""

    def __init__(self, db_fname: str,
                 comp_to_uncomp: Optional[Dict[str, str]] = None):
        import threading
        if not os.path.isfile(db_fname):
            raise FileNotFoundError(db_fname)
        self.db_fname = db_fname
        self.comp_to_uncomp = comp_to_uncomp
        self.uncomp_to_comp = None
        if comp_to_uncomp is not None:
            self.uncomp_to_comp = {v: k for k, v in comp_to_uncomp.items()}
        # the identifier is double-quoted in every statement: chromosome
        # names commonly contain '.' or '-' (scaffolds), which are
        # illegal in bare SQL identifiers
        self.table_name = '"table_%s"' % get_table_name_from_file(
            db_fname).replace('"', '""')
        # shared across reader threads (summarize/compare thread pools);
        # queries serialize under the lock
        self.conn = sqlite3.connect(self.db_fname,
                                    check_same_thread=False)
        self._lock = threading.Lock()
        self.is_db_events_compressed = self._first_event_compressed()

    def _first_event_compressed(self) -> bool:
        from miso_jax.io.gff import is_compressed_name
        c = self.conn.cursor()
        row = c.execute("SELECT * from %s" % self.table_name).fetchone()
        if row is None:
            return False
        return is_compressed_name(str(row[0]))

    def _resolve_name(self, event_name: str):
        from miso_jax.io.gff import is_compressed_name
        if self.is_db_events_compressed and not is_compressed_name(event_name):
            if self.uncomp_to_comp is None:
                raise ValueError(
                    "The database contains compressed IDs but no mapping "
                    "(.shelve) file was given.")
            return self.uncomp_to_comp.get(event_name)
        if (not self.is_db_events_compressed) and \
                is_compressed_name(event_name):
            if self.comp_to_uncomp is None:
                return None
            return self.comp_to_uncomp.get(event_name)
        return event_name

    def get_event_raw(self, event_name: str):
        """(psi_vals_and_scores, header_block) text columns, or None."""
        event_to_query = self._resolve_name(event_name)
        if event_to_query is None:
            return None
        with self._lock:
            rows = self.conn.execute(
                "SELECT * from %s WHERE event_name=?" % self.table_name,
                (event_to_query,)).fetchall()
        if len(rows) == 0:
            return None
        if len(rows) > 1:
            raise ValueError("More than one entry for event %s"
                             % event_to_query)
        _, psi_vals_and_scores, header = rows[0]
        return psi_vals_and_scores, header

    def get_event_data_as_stream(self, event_name: str):
        row = self.get_event_raw(event_name)
        if row is None:
            return None
        psi_vals_and_scores, header = row
        return io.StringIO("%s%s" % (header, psi_vals_and_scores))

    def get_all_event_names(self) -> List[str]:
        c = self.conn.cursor()
        return [row[0] for row in
                c.execute("SELECT event_name from %s" % self.table_name)]


def load_miso_file_as_str(miso_filename: str):
    if not os.path.isfile(miso_filename):
        return None
    with open(miso_filename) as f:
        lines = f.readlines()
    header = "".join(lines[:2])
    return header, "".join(lines[2:])


class DirectPacker:
    """Stream events into per-chromosome `.miso_db` files DURING the
    run (`miso --run --pack-output`): when the user wants packed
    output, writing a multi-GB .miso text tree and then re-reading it
    with `miso_pack` (misopy/miso_pack.py:29-79) is pure waste.  The
    sqlite schema matches miso_dir_to_db exactly, so MISOSamples and
    every downstream tool read the result unchanged.

    Thread-safe: the pipeline's write pool calls add() concurrently;
    inserts buffer per chromosome and flush with executemany under one
    lock.  Events already present in an existing database are exposed
    via `done_names` so resumed runs skip them (the packed analogue of
    the .miso skip-if-exists rule, miso_sampler.py:234-238)."""

    FLUSH_EVERY = 256

    def __init__(self, output_dir: str):
        import threading
        self.output_dir = output_dir
        self.lock = threading.Lock()
        self.conns: Dict[str, sqlite3.Connection] = {}
        self.pending: Dict[str, list] = {}
        self.done_names: set = set()
        os.makedirs(output_dir, exist_ok=True)
        for db in glob.glob(os.path.join(output_dir, "*" + MISO_DB_EXT)):
            chrom = get_table_name_from_file(db)
            conn = self._open(chrom)
            for (nm,) in conn.execute(
                    'SELECT event_name from "table_%s"'
                    % chrom.replace('"', '""')):
                self.done_names.add(str(nm))

    def _open(self, chrom: str) -> sqlite3.Connection:
        conn = self.conns.get(chrom)
        if conn is None:
            path = os.path.join(self.output_dir, chrom + MISO_DB_EXT)
            conn = sqlite3.connect(path, check_same_thread=False)
            # fresh-output writes: journaling/fsync buy nothing (a
            # crashed run is simply re-run; resume skips done events),
            # and they bound insert throughput
            conn.execute("PRAGMA journal_mode=OFF")
            conn.execute("PRAGMA synchronous=OFF")
            q = chrom.replace('"', '""')
            conn.execute(
                'CREATE TABLE IF NOT EXISTS "table_%s" '
                "(event_name text, psi_vals_and_scores text, header text)"
                % q)
            # the reference schema has no index, so per-event reads
            # table-scan; indexing costs little here and makes packed
            # summarize/compare O(log n) per lookup
            conn.execute(
                'CREATE INDEX IF NOT EXISTS "idx_%s" ON "table_%s" '
                "(event_name)" % (q, q))
            self.conns[chrom] = conn
            self.pending[chrom] = []
        return conn

    def add(self, chrom: Optional[str], event_name: str, header: str,
            body: str) -> None:
        chrom = chrom if chrom else "NA"
        with self.lock:
            self._open(chrom)
            self.pending[chrom].append((event_name, body, header))
            if len(self.pending[chrom]) >= self.FLUSH_EVERY:
                self._flush(chrom)

    def _flush(self, chrom: str) -> None:
        rows = self.pending[chrom]
        if rows:
            self.conns[chrom].executemany(
                'INSERT INTO "table_%s" VALUES (?, ?, ?)'
                % chrom.replace('"', '""'), rows)
            self.pending[chrom] = []

    def finish(self) -> None:
        with self.lock:
            for chrom, conn in self.conns.items():
                self._flush(chrom)
                conn.commit()
                conn.close()
            self.conns.clear()


def miso_dir_to_db(dir_to_compress: str,
                   output_filename: str) -> Optional[str]:
    """Pack one directory of `.miso` files into one `.miso_db`
    (misopy/miso_db.py:144-193)."""
    if not os.path.isdir(dir_to_compress):
        print("Error: %s not a directory, aborting." % dir_to_compress)
        sys.exit(1)
    miso_filenames = glob.glob(os.path.join(dir_to_compress, "*.miso"))
    if os.path.isfile(output_filename):
        print("Error: Database %s already exists, aborting." % output_filename)
        return None
    conn = sqlite3.connect(output_filename)
    c = conn.cursor()
    c.execute("PRAGMA journal_mode=OFF")
    c.execute("PRAGMA synchronous=OFF")
    base = os.path.basename(dir_to_compress).replace('"', '""')
    table_name = '"table_%s"' % base
    c.execute("CREATE TABLE %s "
              "(event_name text, psi_vals_and_scores text, header text)"
              % table_name)
    c.execute('CREATE INDEX "idx_%s" ON %s (event_name)'
              % (base, table_name))
    for miso_fname in miso_filenames:
        fields = load_miso_file_as_str(miso_fname)
        if fields is None:
            print("Error: Cannot compress %s. Aborting." % miso_fname)
            return None
        header, psi_vals_and_scores = fields
        event_name = strip_miso_ext(os.path.basename(miso_fname))
        c.execute("INSERT INTO %s VALUES (?, ?, ?)" % table_name,
                  (event_name, psi_vals_and_scores, header))
    conn.commit()
    conn.close()
    return output_filename
