"""Transparent-open input sources (kopen.c analogue): http URL, stdin
pipe, gz over both, must parse identically to plain file input."""
import gzip
import http.server
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from genome_sim import random_genome, sample_reads, write_reads


def _serve(directory):
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(directory), **kw
    )
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, srv.server_address[1]


def test_http_and_gz_http_input(tmp_path, rng):
    g = random_genome(rng, 8000)
    reads = sample_reads(rng, g, coverage=4, read_len=1500)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    with open(fa, "rb") as f:
        gz = gzip.compress(f.read())
    (tmp_path / "reads.fa.gz").write_bytes(gz)

    srv, port = _serve(tmp_path)
    try:
        from oatk_tpu.io.fastx import read_fastx

        base = read_fastx([str(fa)])
        via_http = read_fastx([f"http://127.0.0.1:{port}/reads.fa"])
        via_http_gz = read_fastx([f"http://127.0.0.1:{port}/reads.fa.gz"])
        assert len(base) == len(via_http) == len(via_http_gz)
        for a, b, c in zip(base, via_http, via_http_gz):
            assert a.name == b.name == c.name
            assert np.array_equal(a.seq, b.seq) and np.array_equal(a.seq, c.seq)
    finally:
        srv.shutdown()


def test_gz_over_stdin_pipe(tmp_path, rng):
    """gzip data on a pipe (no seek; short peek) must decompress: the
    magic bytes are read exactly and replayed through a prefixed
    stream."""
    import io as _io

    g = random_genome(rng, 6000)
    reads = sample_reads(rng, g, coverage=4, read_len=1200)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    gz = gzip.compress(fa.read_bytes())

    class OneBytePipe(_io.RawIOBase):
        """Worst case: every raw read returns a single byte."""

        def __init__(self, data):
            self.data = data
            self.pos = 0

        def readable(self):
            return True

        def readinto(self, b):
            if self.pos >= len(self.data):
                return 0
            b[0] = self.data[self.pos]
            self.pos += 1
            return 1

    from oatk_tpu.io import fastx as FX

    base = FX.read_fastx([str(fa)])
    # drive the sniffing logic directly on the 1-byte pipe
    fp = _io.BufferedReader(OneBytePipe(gz), buffer_size=1)
    magic = b""
    while len(magic) < 2:
        chunk = fp.read(2 - len(magic))
        if not chunk:
            break
        magic += chunk
    assert magic == b"\x1f\x8b"
    chained = _io.BufferedReader(FX._Prefixed(magic, fp))
    records = list(FX._iter_fastx(gzip.open(chained, "rb"), 0))
    assert len(records) == len(base)
    for a, b in zip(records, base):
        assert a.name == b.name and np.array_equal(a.seq, b.seq)


def test_stdin_pipe_syncasm(tmp_path, rng):
    """`syncasm -` consumes a FASTA piped on stdin and matches the
    file-input assembly byte-for-byte."""
    g = random_genome(rng, 15000)
    reads = sample_reads(rng, g, coverage=10, read_len=2000)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(Path(__file__).parent.parent))
    args = ["-k", "151", "-s", "13", "-c", "3", "--no-read-ec",
            "--unzip-round", "0"]
    subprocess.run(
        [sys.executable, "-m", "oatk_tpu.cli.syncasm", *args,
         "-o", str(tmp_path / "file"), str(fa)],
        check=True, capture_output=True, env=env,
    )
    with open(fa, "rb") as f:
        subprocess.run(
            [sys.executable, "-m", "oatk_tpu.cli.syncasm", *args,
             "-o", str(tmp_path / "pipe"), "-"],
            check=True, capture_output=True, env=env, stdin=f,
        )
    a = (tmp_path / "file.utg.final.gfa").read_bytes()
    b = (tmp_path / "pipe.utg.final.gfa").read_bytes()
    assert a == b and a


def test_pipe_open_command_input(tmp_path, rng):
    """'<cmd' inputs (kopen.c:286-311 pipe open) stream the command's
    stdout: plain argv commands and shell pipelines, with gz sniffed."""
    g = random_genome(rng, 6000)
    reads = sample_reads(rng, g, coverage=4, read_len=1200)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    (tmp_path / "reads.fa.gz").write_bytes(gzip.compress(fa.read_bytes()))

    from oatk_tpu.io.fastx import read_fastx

    base = read_fastx([str(fa)])
    # plain command (no shell: '/' is punct in the reference's check, so
    # this exercises the shell branch like the reference would)
    via_cat = read_fastx([f"<cat {fa}"])
    # explicit shell pipeline
    via_zcat = read_fastx([f"<gzip -dc {tmp_path}/reads.fa.gz | head -c 10000000"])
    assert len(base) == len(via_cat) == len(via_zcat)
    for a, b, c in zip(base, via_cat, via_zcat):
        assert a.name == b.name == c.name
        assert np.array_equal(a.seq, b.seq) and np.array_equal(a.seq, c.seq)
    # gz magic sniffing still applies on pipe output
    via_cat_gz = read_fastx([f"<cat {tmp_path}/reads.fa.gz"])
    assert len(via_cat_gz) == len(base)
    assert np.array_equal(via_cat_gz[0].seq, base[0].seq)


def test_threaded_fastq_parse_with_at_qualities(rng):
    """Threaded FASTQ parse must split on 4-line records even when
    quality strings are all '@'/'>' (the aliasing the FASTA splitter
    cannot handle)."""
    from oatk_tpu import native

    if not native.available():
        import pytest as _pytest

        _pytest.skip("native library unavailable")
    parts = []
    for i in range(9000):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
        parts.append(f"@r{i} extra\n{seq}\n+\n{'@' * 300}{'>' * 300}\n")
    data = "".join(parts).encode()
    assert len(data) > (4 << 20)
    a = native.parse_fastx_hoco(data)
    b = native.parse_fastx_hoco_mt(data)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(x, y)
