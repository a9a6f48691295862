"""tools/stream_compare.py's reading of the CLI's output, on the CPU: the
streams it takes from a single-prompt run and from a --continuous run, and
where two streams first differ."""

import pytest

from distributed_llama_tpu_torch.tools import stream_compare


def test_streams_of_a_single_prompt_are_its_pieces():
    out = ("💡 prompt\n"
           "🔶 G   12 ms I   11 ms T    0 ms S      0 kB R      0 kB ' hi'\n"
           "🔶 G   12 ms I   11 ms T    0 ms S      0 kB R      0 kB 'tok9'\n"
           "Generated tokens:    2\n")
    assert stream_compare.streams(out, False) == [[" hi", "tok9"]]


def test_streams_of_a_continuous_run_are_its_rows():
    out = ("[0] hi hi a\n[1] hi hi bb\n[0] done: 4 tokens\n"
           "Generated tokens: 8 across 2 requests (8 slots, 5 steps)\n")
    assert stream_compare.streams(out, True) == [["hi hi a"], ["hi hi bb"]]


@pytest.mark.parametrize("a,b,want", [
    ([" hi", "tok9"], [" hi", "tok9"], None),
    ([" hi", "tok9"], [" hi", "tok8"], 1),
    ([" hi"], [" hi", "tok8"], 1),
    (["hi hi a"], ["hi hi a"], None),
    (["hi hi ab"], ["hi hi ac"], 7),
])
def test_first_difference(a, b, want):
    assert stream_compare.first_difference(a, b) == want
