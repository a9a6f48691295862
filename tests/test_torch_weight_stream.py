"""The port's root -> worker weight streaming (io/stream.py) against the JAX
package's (twin: tests/test_weight_stream.py): each package's client
fetches byte for byte from the other's server, the sidecars cross both
ways, the needed ranges under ``ref`` are the JAX function's, and under
every scheme a sliced fetch loads the bands a whole file gives; then the
cache, resume and repair cases of the twin."""

import json
import os
import threading

import numpy as np
import pytest

from distributed_llama_tpu_torch.io import stream
from distributed_llama_tpu_torch.io.loader import write_model
from distributed_llama_tpu_torch.models.spec import (HEADER_BYTES,
                                                      TransformerSpec)
from distributed_llama_tpu_torch.ops.quants import FloatType

SCHEMES = ("ref", "fused", "overlap")
# tp 2 and 4 divide heads, kv heads, hidden and vocab; wo's 4 and w2's 8
# Q40 blocks a row divide over tp 4 (fused and overlap band them)
SPEC = TransformerSpec(dim=128, hidden_dim=256, n_layers=2, n_heads=8,
                       n_kv_heads=4, vocab_size=300, seq_len=32,
                       weights_float_type=FloatType.Q40)
F32_SPEC = TransformerSpec(dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=32,
                           weights_float_type=FloatType.F32)


def _write(path, spec, seed=5):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    tensors = {"tok_embedding": t(spec.vocab_size, spec.dim),
               "rms_att": 1 + t(spec.n_layers, spec.dim),
               "rms_ffn": 1 + t(spec.n_layers, spec.dim),
               "rms_final": 1 + t(spec.dim),
               "wcls": t(spec.vocab_size, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        tensors[name] = t(spec.n_layers, *shape)
    write_model(str(path), spec, tensors)
    return str(path)


def _jax_spec(spec):
    from distributed_llama_tpu.models.spec import \
        TransformerSpec as JaxSpec

    return JaxSpec.from_header(spec.header(), spec.weights_float_type,
                               spec.weights_float_type)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("m") / "model.bin", SPEC)


@pytest.fixture()
def served(tmp_path, model):
    server = stream.WeightServer(model, host="127.0.0.1")
    yield server, f"127.0.0.1:{server.port}", model, tmp_path
    server.close()


@pytest.fixture()
def blob(tmp_path):
    """An odd-sized random file and its bytes (the twin's fixture)."""
    data = np.random.default_rng(3).integers(
        0, 256, 9_000_017, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    return str(path), data


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client", ["port", "jax"])
def test_each_package_fetches_byte_exact_from_the_others_server(
        tmp_path, blob, client):
    from distributed_llama_tpu.io import stream as jax_stream

    src, data = blob
    server_mod, fetch_mod = ((jax_stream, stream) if client == "port"
                             else (stream, jax_stream))
    server = server_mod.WeightServer(src, host="127.0.0.1")
    try:
        dst = str(tmp_path / "fetched" / "model.bin")
        got = fetch_mod.fetch_model(f"127.0.0.1:{server.port}", dst,
                                    quiet=True)
        assert got == dst
        assert open(dst, "rb").read() == data
        assert not [p for p in os.listdir(os.path.dirname(dst))
                    if p.endswith(".part")]  # renamed into place
    finally:
        server.close()


@pytest.mark.parametrize("spec", [SPEC, F32_SPEC], ids=["q40", "f32"])
def test_needed_ranges_under_ref_are_the_jax_packages(spec):
    from distributed_llama_tpu.io.stream import \
        needed_byte_ranges as jax_needed

    js = _jax_spec(spec)
    for tp in (1, 2, 4):
        if spec.n_kv_heads % tp:
            continue
        for ranks in [{r} for r in range(tp)] + [set(range(tp)),
                                                 {0, tp - 1}]:
            assert stream.needed_byte_ranges(spec, tp, ranks, "ref") == \
                jax_needed(js, tp, ranks), (tp, ranks)


def test_needed_ranges_fetch_input_banded_tensors_whole():
    """fused/overlap band wo and w2 on their input dim: each is fetched
    whole, every other matmul as its row band, as under ref."""
    from distributed_llama_tpu_torch.io.loader import tensor_byte_ranges

    trs = tensor_byte_ranges(SPEC)
    inb = sum(tr.nbytes for tr in trs if tr.name in ("wo", "w2"))
    outb = sum(tr.nbytes for tr in trs
               if tr.rows is not None and tr.name not in ("wo", "w2"))
    repl = sum(tr.nbytes for tr in trs
               if tr.rows is None and tr.name != "_rope_gap")
    ref = stream.needed_byte_ranges(SPEC, 2, {1}, "ref")
    assert sum(ln for _, ln in ref) == HEADER_BYTES + repl + (outb
                                                             + inb) // 2
    for scheme in ("fused", "overlap"):
        need = stream.needed_byte_ranges(SPEC, 2, {1}, scheme)
        assert sum(ln for _, ln in need) == HEADER_BYTES + repl \
            + outb // 2 + inb
        assert stream.subtract_ranges(ref, need) == []
        for tr in trs:
            if tr.name in ("wo", "w2"):
                assert stream.subtract_ranges([(tr.offset, tr.nbytes)],
                                              need) == []
    with pytest.raises(ValueError, match="invalid for tp=2"):
        stream.needed_byte_ranges(SPEC, 2, {2}, "fused")


def _band_cases():
    return [(tp, rank, scheme) for tp in (2, 4) for rank in range(tp)
            for scheme in SCHEMES]


@pytest.mark.parametrize("tp,rank,scheme", _band_cases(),
                         ids=[f"tp{t}-r{r}-{s}" for t, r, s in _band_cases()])
def test_sliced_fetch_loads_the_bands_of_the_whole_file(served, tp, rank,
                                                        scheme):
    from distributed_llama_tpu_torch.parallel.tp import load_model_bands

    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, tp, {rank}, scheme,
                              quiet=True)
    need = stream.needed_byte_ranges(SPEC, tp, {rank}, scheme)
    with open(dst + ".slices") as fh:
        assert [tuple(e[:2]) for e in json.load(fh)["ranges"]] == need
    _, want = load_model_bands(src, rank, tp, scheme, FloatType.Q40)
    _, got = load_model_bands(dst, rank, tp, scheme, FloatType.Q40)
    assert want.keys() == got.keys()
    for name in want:
        for w, g in zip(_leaves(want[name]), _leaves(got[name])):
            np.testing.assert_array_equal(g, w, err_msg=name)


def _leaves(value):
    """A Q40 weight's planes, or the array."""
    return (value.qs, value.d16) if hasattr(value, "qs") else (value,)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sliced_f32_fetch_loads_every_ranks_bands(tmp_path, scheme):
    """F32 weights: an input band is n/tp values of every row."""
    from distributed_llama_tpu_torch.parallel.tp import load_model_bands

    src = _write(tmp_path / "f32.bin", F32_SPEC)
    server = stream.WeightServer(src, host="127.0.0.1")
    try:
        for rank in range(2):
            dst = str(tmp_path / f"r{rank}" / "model.bin")
            stream.fetch_model_slices(f"127.0.0.1:{server.port}", dst,
                                      FloatType.F32, 2, {rank}, scheme,
                                      quiet=True)
            _, want = load_model_bands(src, rank, 2, scheme, FloatType.F32)
            _, got = load_model_bands(dst, rank, 2, scheme, FloatType.F32)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=name)
    finally:
        server.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecars_cross_between_the_packages(served, writer):
    """A sliced fetch by one package leaves a sidecar the other reads (the
    same verified ranges) and takes as a cache hit; a range damaged on
    disk fails its CRC in the other's reader too."""
    from distributed_llama_tpu.io import stream as jax_stream

    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    def fetch(mod):  # row bands: the one layout the JAX package fetches
        extra = ("ref",) if mod is stream else ()
        mod.fetch_model_slices(addr, dst, FloatType.Q40, 2, {1}, *extra,
                               quiet=True)

    fetcher, reader = ((stream, jax_stream) if writer == "port"
                       else (jax_stream, stream))
    fetch(fetcher)
    have = reader.verified_ranges(dst)
    assert have == stream.needed_byte_ranges(SPEC, 2, {1}, "ref")
    assert fetcher.verified_ranges(dst) == have
    before = os.path.getmtime(dst)
    fetch(reader)
    assert os.path.getmtime(dst) == before  # a hit: nothing fetched
    off, ln = have[-1]
    with open(dst, "r+b") as fh:
        fh.seek(off + ln // 2)
        byte = fh.read(1)
        fh.seek(off + ln // 2)
        fh.write(bytes([byte[0] ^ 0xFF]))
    assert reader.verified_ranges(dst) == have[:-1]


def test_record_sidecar_reads_in_both_packages(tmp_path):
    """append_record_verified's unmerged records, read back per record."""
    from distributed_llama_tpu.io import stream as jax_stream

    path = str(tmp_path / "seg.bin")
    recs = [stream.append_record_verified(path, bytes([i]) * (100 + i))
            for i in range(3)]
    assert jax_stream.verified_ranges(path) == [(o, n) for o, n, _ in recs]
    for off, n, crc in recs:
        assert jax_stream.read_record_verified(path, off, n, crc) == \
            stream.read_record_verified(path, off, n, crc)
    entries = []
    jax_stream.append_record_verified(path, b"x" * 7, entries)
    stream.write_record_sidecar(path, os.path.getsize(path),
                                [[o, n, c] for o, n, c in recs] + entries)
    assert stream.verified_ranges(path) == jax_stream.verified_ranges(path)
    assert stream.read_record_verified(path, 0, 100, recs[0][2] ^ 1) is None


def test_range_algebra_is_the_jax_packages():
    from distributed_llama_tpu.io import stream as jax_stream

    assert stream.merge_ranges([(10, 5), (0, 4), (14, 6), (3, 2)]) == [
        (0, 5), (10, 10)]
    assert stream.subtract_ranges([(5, 10)], [(0, 7), (12, 100)]) == [
        (7, 5)]
    rng = np.random.default_rng(11)
    for _ in range(50):
        a = [tuple(int(v) for v in rng.integers(0, 64, 2)) for _ in range(5)]
        b = [tuple(int(v) for v in rng.integers(0, 64, 2)) for _ in range(5)]
        assert stream.merge_ranges(a) == jax_stream.merge_ranges(a)
        assert stream.subtract_ranges(a, b) == \
            jax_stream.subtract_ranges(a, b)


# ---------------------------------------------------------------------------
# the twin's cases
# ---------------------------------------------------------------------------

def test_fetch_skips_an_existing_cache(tmp_path, blob):
    src, data = blob
    server = stream.WeightServer(src, host="127.0.0.1")
    try:
        dst = str(tmp_path / "cache.bin")
        with open(dst, "wb") as f:
            f.write(data)
        before = os.path.getmtime(dst)
        stream.fetch_model(f"127.0.0.1:{server.port}", dst, quiet=True)
        assert os.path.getmtime(dst) == before
    finally:
        server.close()


def test_concurrent_fetchers(tmp_path, blob):
    src, data = blob
    server = stream.WeightServer(src, host="127.0.0.1")
    errs = []

    def fetch(i):
        try:
            p = str(tmp_path / f"w{i}" / "model.bin")
            stream.fetch_model(f"127.0.0.1:{server.port}", p, quiet=True)
            assert open(p, "rb").read() == data
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.close()
    assert not errs


def test_protocol_mismatch_raises(tmp_path):
    import socketserver

    class Junk(socketserver.BaseRequestHandler):
        def handle(self):
            self.request.recv(64)
            self.request.sendall(b"HTTP/1.1 200 OK\r\n" + b"x" * 16)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = Server(("127.0.0.1", 0), Junk)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with pytest.raises(ValueError, match="protocol mismatch"):
            stream.fetch_model(f"127.0.0.1:{srv.server_address[1]}",
                               str(tmp_path / "x.bin"), quiet=True)
    finally:
        srv.shutdown()
        srv.server_close()


def test_fetch_repairs_a_truncated_cache(tmp_path, blob):
    src, data = blob
    server = stream.WeightServer(src, host="127.0.0.1")
    try:
        dst = str(tmp_path / "stale.bin")
        with open(dst, "wb") as f:
            f.write(data[:1000])
        stream.fetch_model(f"127.0.0.1:{server.port}", dst, quiet=True)
        assert open(dst, "rb").read() == data
    finally:
        server.close()


def test_connect_retry_tolerates_a_late_server(tmp_path):
    import socket
    import time

    src = tmp_path / "m.bin"
    src.write_bytes(b"z" * 4096)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    box = {}

    def late_start():
        time.sleep(1.0)
        box["server"] = stream.WeightServer(str(src), host="127.0.0.1",
                                            port=port)

    t = threading.Thread(target=late_start)
    t.start()
    try:
        dst = str(tmp_path / "out.bin")
        stream.fetch_model(f"127.0.0.1:{port}", dst, quiet=True,
                           connect_window=15)
        assert open(dst, "rb").read() == b"z" * 4096
    finally:
        t.join()
        box["server"].close()


def test_connect_nontransient_raises_at_once(monkeypatch):
    import errno
    import time

    attempts = {"n": 0}

    def denied(addr, timeout=None):
        attempts["n"] += 1
        raise OSError(errno.EACCES, "permission denied")

    monkeypatch.setattr(stream.socket, "create_connection", denied)
    slept: list[float] = []
    monkeypatch.setattr(time, "sleep", lambda d: slept.append(d))
    with pytest.raises(OSError):
        stream._connect_with_retry("127.0.0.1", 1, timeout=1,
                                   connect_window=30)
    assert attempts["n"] == 1 and not slept


def test_connect_backoff_grows_exponentially(monkeypatch):
    import socket
    import time

    assert stream._is_transient(ConnectionRefusedError())
    assert stream._is_transient(socket.timeout())
    assert not stream._is_transient(socket.gaierror())
    assert stream._is_transient(socket.gaierror(socket.EAI_AGAIN, "again"))
    assert not stream._is_transient(socket.gaierror(socket.EAI_NONAME, "x"))
    assert not stream._is_transient(OSError(28, "No space left on device"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    delays: list[float] = []
    monkeypatch.setattr(time, "sleep", lambda d: delays.append(d))
    with pytest.raises(OSError):
        stream._connect_with_retry("127.0.0.1", port, timeout=1,
                                   connect_window=0.3)
    assert delays[:3] == [0.05, 0.1, 0.2]


def test_slice_fetch_hits_its_cache_and_tops_up_to_the_whole_file(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 2, {1}, "ref",
                              quiet=True)
    assert os.path.getsize(dst) == os.path.getsize(src)
    before = os.path.getmtime(dst)
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 2, {1}, "ref",
                              quiet=True)
    assert os.path.getmtime(dst) == before
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 2, {0, 1}, "ref",
                              quiet=True)
    assert open(dst, "rb").read() == open(src, "rb").read()


def test_resume_after_a_dropped_connection(served, monkeypatch, capsys):
    """The connection drops mid-transfer (twice): the fetch resumes from
    the chunks that landed, fetches no byte twice, and the file and its
    sidecar come out as an uninterrupted fetch's."""
    _, addr, src, tmp_path = served
    real = stream._recv_exact
    calls = {"n": 0, "bytes": 0}

    def flaky(sock, n, into=None):
        calls["n"] += 1
        if calls["n"] in (4, 9):
            sock.close()
            raise ConnectionResetError(104, "connection reset by peer")
        calls["bytes"] += n
        return real(sock, n, into)

    monkeypatch.setattr(stream, "_recv_exact", flaky)
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 2, {0}, "fused",
                              chunk_bytes=4096)
    err = capsys.readouterr().err
    assert err.count("dropped mid-transfer") == 2
    monkeypatch.setattr(stream, "_recv_exact", real)
    ref = str(tmp_path / "ref" / "model.bin")
    stream.fetch_model_slices(addr, ref, FloatType.Q40, 2, {0}, "fused",
                              quiet=True)
    assert open(dst, "rb").read() == open(ref, "rb").read()
    with open(dst + ".slices") as a, open(ref + ".slices") as b:
        assert json.load(a) == json.load(b)
    need = sum(ln for _, ln in stream.needed_byte_ranges(SPEC, 2, {0},
                                                         "fused"))
    # three handshakes of 14 bytes, the header read for the spec, then
    # every needed byte once
    assert calls["bytes"] == 3 * 14 + HEADER_BYTES + need


def test_corrupt_sidecar_triggers_a_full_refetch(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    good = open(dst, "rb").read()
    with open(dst + ".slices", "w") as fh:
        fh.write('{"size": 12, "ran')
    with open(dst, "r+b") as fh:
        fh.write(b"\0" * 4096)
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    assert open(dst, "rb").read() == good
    with open(dst + ".slices") as fh:
        assert json.load(fh)["ranges"]


def test_wrong_size_sidecar_is_ignored(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    good = open(dst, "rb").read()
    size = os.path.getsize(src)
    with open(dst, "r+b") as fh:
        fh.write(b"\0" * 4096)
    with open(dst + ".slices", "w") as fh:
        json.dump({"size": size + 1, "ranges": [[0, size]]}, fh)
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    assert open(dst, "rb").read() == good


def test_killed_fetch_residue_is_refetched_not_trusted(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    os.makedirs(os.path.dirname(dst))
    with open(dst, "wb") as fh:
        fh.truncate(os.path.getsize(src))
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    ref = str(tmp_path / "ref" / "model.bin")
    stream.fetch_model_slices(addr, ref, FloatType.Q40, 1, {0}, quiet=True)
    assert open(dst, "rb").read() == open(ref, "rb").read()


def test_crc_mismatch_refetches_the_damaged_range(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    good = open(dst, "rb").read()
    pos = os.path.getsize(src) // 2
    with open(dst, "r+b") as fh:
        fh.seek(pos)
        byte = fh.read(1)
        fh.seek(pos)
        fh.write(bytes([byte[0] ^ 0xFF]))
    before = os.path.getmtime(dst)
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 1, {0}, quiet=True)
    assert open(dst, "rb").read() == good
    assert os.path.getmtime(dst) != before


def test_sparse_file_is_never_mistaken_for_a_full_one(served):
    _, addr, src, tmp_path = served
    dst = str(tmp_path / "w" / "model.bin")
    os.makedirs(os.path.dirname(dst))
    with open(dst, "wb") as fh:
        fh.truncate(os.path.getsize(src))
    with open(dst + ".slices", "w") as fh:
        json.dump({"size": os.path.getsize(src), "ranges": []}, fh)
    stream.fetch_model_slices(addr, dst, FloatType.Q40, 2, {0}, quiet=True)
    with open(dst + ".slices") as fh:
        assert json.load(fh)["ranges"]
    stream.fetch_model(addr, dst, quiet=True)
    assert open(dst, "rb").read() == open(src, "rb").read()
    assert not os.path.exists(dst + ".slices")
