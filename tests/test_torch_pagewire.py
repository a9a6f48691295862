"""The port's page wire codec (runtime/pagewire.py) and handoff record
against the JAX package's and the golden wire corpus (tests/fixtures/wire/):

* f32 and Q8 planes round-trip byte-exact, and damage (a flipped payload
  byte, truncation, garbage) decodes to None;
* the port's ``encode_record`` gives the JAX record of the same planes
  byte for byte, each side decodes the other's, and ``pack_planes`` is
  the disk tier's record (the port's DiskPageStore writes the blob);
* the port reads ``pagewire/v1`` (f32 and Q8 frames) and ``handoff/v1``
  and ``v2`` to their ``expect.json``, and reproduces ``handoff/v2``
  byte for byte through its own tracectx and journal codec.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIRE = ROOT / "tests" / "fixtures" / "wire"
sys.path.insert(0, str(ROOT / "tools"))

import make_wire_corpus as corpus  # noqa: E402  (its call data)

from distributed_llama_tpu.runtime import pagewire as ref  # noqa: E402
from distributed_llama_tpu_torch.runtime import pagewire  # noqa: E402


def _planes(kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return (rng.standard_normal((2, 4, 2, 16)).astype(np.float32),
                rng.standard_normal((2, 4, 2, 16)).astype(np.float32))
    if kind == "bf16":  # a bf16 pool's planes travel as int16 words
        return (rng.integers(-2 ** 15, 2 ** 15, (2, 4, 2, 16),
                             dtype=np.int16),
                rng.integers(-2 ** 15, 2 ** 15, (2, 4, 2, 16),
                             dtype=np.int16))
    return (rng.integers(-127, 127, (2, 4, 2, 16), dtype=np.int8),
            rng.standard_normal((2, 4, 1)).astype(np.float16),
            rng.integers(-127, 127, (2, 4, 2, 16), dtype=np.int8),
            rng.standard_normal((2, 4, 1)).astype(np.float16))


@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
def test_round_trip_byte_exact(kind):
    planes = _planes(kind)
    rec = pagewire.encode_record(planes)
    got = pagewire.decode_record(rec)
    assert got is not None and len(got) == len(planes)
    for a, b in zip(planes, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert pagewire.record_payload_bytes(rec) == \
        sum(a.nbytes for a in planes) == \
        pagewire.record_payload_bytes(planes)


def test_damage_decodes_to_none():
    planes = (np.arange(32, dtype=np.float32).reshape(2, 16),)
    rec = bytearray(pagewire.encode_record(planes))
    corrupt = bytes(rec[:-5]) + bytes([rec[-5] ^ 0xFF]) + bytes(rec[-4:])
    assert pagewire.decode_record(corrupt) is None
    assert pagewire.decode_record(bytes(rec[:-3])) is None
    assert pagewire.decode_record(bytes(rec) + b"x") is None
    assert pagewire.decode_record(b"\x00" * 8) is None
    assert pagewire.decode_record(b"\x01") is None
    garbled = bytearray(rec)
    garbled[5] ^= 0xFF  # inside the metadata json
    assert pagewire.decode_record(bytes(garbled)) is None
    assert pagewire.decode_record(bytes(rec)) is not None


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_record_equals_the_jax_record(kind):
    planes = _planes(kind, seed=11)
    mine = pagewire.encode_record(planes)
    theirs = ref.encode_record(planes)
    assert mine == theirs
    for dec, rec in ((pagewire.decode_record, theirs),
                     (ref.decode_record, mine)):
        back = dec(rec)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(planes, back))
    assert pagewire.pack_planes(planes) == ref.pack_planes(planes)


def test_disk_record_is_the_wire_blob(tmp_path):
    from distributed_llama_tpu_torch.runtime.paging import DiskPageStore

    payload = _planes("f32", seed=5)
    store = DiskPageStore(str(tmp_path / "disk"))
    path, off, length, crc, metas = store.store(payload)
    with open(path, "rb") as fh:
        fh.seek(off)
        disk_bytes = fh.read(length)
    blob, wire_metas = pagewire.pack_planes(payload)
    assert disk_bytes == blob and wire_metas == metas


@pytest.mark.parametrize("name", ["f32", "q8"])
def test_reads_the_pagewire_corpus(name):
    want = json.loads((WIRE / "pagewire" / "v1" / "expect.json")
                      .read_text())[name]
    rec = (WIRE / "pagewire" / "v1" / f"{name}.bin").read_bytes()
    planes = pagewire.decode_record(rec)
    assert planes is not None and len(planes) == want["n_planes"]
    assert [list(p.shape) for p in planes] == want["shapes"]
    assert [p.dtype.str for p in planes] == want["dtypes"]
    assert pagewire.record_payload_bytes(rec) == want["payload_bytes"]
    built = (corpus._f32_planes() if name == "f32"
             else corpus._q8_planes())
    assert all(a.tobytes() == b.tobytes() for a, b in zip(planes, built))
    assert pagewire.encode_record(planes) == rec  # and writes it again


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_reads_the_handoff_corpus(version):
    from distributed_llama_tpu_torch.runtime.journal import entry_from_wire

    d = WIRE / "handoff" / version
    entry = entry_from_wire(json.loads((d / "record.json").read_text()))
    want = json.loads((d / "expect.json").read_text())
    assert entry.rid == want["rid"]
    assert entry.replay_tokens == want["replay_tokens"]
    assert entry.cursor == want["cursor"]
    if version == "v1":
        assert entry.trace is want["trace"] is None
        assert entry.ledger is want["ledger"] is None
    else:
        assert bool(entry.trace) is want["has_trace"]
        assert entry.ledger["tokens"] == want["ledger_tokens"]


def test_reproduces_handoff_v2():
    from distributed_llama_tpu_torch.obs import tracectx
    from distributed_llama_tpu_torch.runtime.journal import (JournalEntry,
                                                             entry_to_wire)

    tracectx.seed_ids(77)
    try:
        entry = JournalEntry(
            rid=7, tokens=[3, 1, 4], steps=6, temperature=0.7,
            topp=0.95, seed=21, slo="interactive", cursor=1,
            sampled=[15], trace=tracectx.mint().to_header(),
            ledger={"tokens": 1, "page_steps": 4, "compute_s": 0.25})
    finally:
        tracectx.seed_ids(None)
    got = json.dumps(entry_to_wire(entry), separators=(",", ":")).encode()
    assert got == (WIRE / "handoff" / "v2" / "record.json").read_bytes()
    assert got == corpus.build_handoff_v2()
