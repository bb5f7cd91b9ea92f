"""`quiver_tpu_torch.graphs`, the bookkeeping the captured serve step
(`inference.BucketPrograms`) and the captured train step
(`train_programs.TrainPrograms`) share, and `_kernels.launch`'s count under
a capture, on the CPU.

A capture and a launch need the card; here the kernel library, the graph
and the stream are stand-ins, so what is held is the bookkeeping alone:
the byte layout of a call's host inputs (each field 8-byte aligned, the
values read back bit-equal through their views), a launch made while the
tallied stream captures goes to the graph's tally and not to
`_kernels.counts` (which keeps the eager launches, and the launches of
other streams), a failed capture is ended and its tally dropped, and a
path's launches are each tally times its replays."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quiver_tpu_torch import _kernels
from quiver_tpu_torch.graphs import GraphBook, Tally, byte_fields, byte_views, capture, stage


def test_byte_fields_align_each_field_and_stage_reads_back_bit_equal():
    rng = np.random.default_rng(0)
    values = [rng.integers(0, 1 << 30, 5).astype(np.int32),
              rng.integers(0, 1 << 32, (3, 2), dtype=np.uint64).astype(np.uint32),
              rng.standard_normal(7).astype(np.float32),
              np.array([12345678901234, -5], np.int64)]
    specs = [(torch.int32, (5,)), (torch.uint32, (3, 2)), (torch.float32, (7,)),
             (torch.int64, (2,))]
    fields, nbytes = byte_fields(specs)
    assert [f[0] for f in fields] == [0, 24, 48, 80] and nbytes == 96
    assert all(o % 8 == 0 for o, *_ in fields)
    views = byte_views(stage(values, fields, nbytes, pin=False), fields)
    for v, t in zip(values, views):
        assert t.shape == v.shape and np.array_equal(t.numpy(), v)
    assert byte_fields([]) == ([], 8)


@pytest.fixture
def fake_card(monkeypatch):
    """`_kernels.launch` over a library whose entry points return 0, with
    the current stream's handle and its capture state set by the test."""
    card = SimpleNamespace(stream=7, capturing=False)
    monkeypatch.setattr(_kernels, "_lib", lambda stem: SimpleNamespace(
        **{fn: (lambda *a: 0) for _, fn, _ in _kernels.KERNELS.values()}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: card.capturing)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=card.stream))
    _kernels.reset_counts()
    yield card
    _kernels.reset_counts()


def test_a_launch_captured_into_a_tally_counts_there_only(fake_card):
    _kernels.launch("masked_mean", variant="float32")  # eager
    _kernels.begin_capture_tally(7)
    fake_card.capturing = True
    _kernels.launch("masked_mean", variant="float32")
    _kernels.launch("masked_mean_backward", variant=("cols", "float32"))
    fake_card.stream = 8  # another stream capturing, with no tally: its launches count
    _kernels.launch("masked_mean", variant="float32")
    fake_card.stream, fake_card.capturing = 7, False
    _kernels.launch("masked_mean", variant="float32")  # the tallied stream, not capturing
    tally = _kernels.end_capture_tally(7)
    assert tally == {"masked_mean": 1, "masked_mean/float32": 1, "masked_mean_backward": 1,
                     "masked_mean_backward/cols": 1, "masked_mean_backward/float32": 1}
    counts = _kernels.counts()
    assert counts["masked_mean"] == counts["masked_mean/float32"] == 3
    assert counts["masked_mean_backward"] == 0
    assert not _kernels._capture_tallies


class _Graph:
    def __init__(self, card):
        self.card, self.calls = card, []

    def capture_begin(self, capture_error_mode):
        self.calls.append(("begin", capture_error_mode))
        self.card.capturing = True

    def capture_end(self):
        self.calls.append("end")
        self.card.capturing = False


def test_capture_tallies_its_stream_and_ends_a_failed_capture(fake_card):
    stream = SimpleNamespace(cuda_stream=7)
    graph = _Graph(fake_card)

    def body():
        _kernels.launch("gather_src", variant="float32")
        _kernels.launch("gather_src", variant="float32")
        return "out"

    out, tally = capture(graph, stream, body)
    assert out == "out" and graph.calls == [("begin", "thread_local"), "end"]
    assert tally.counts == {"gather_src": 2, "gather_src/float32": 2}
    assert tally.replays == 0 and tally.seconds >= 0
    assert _kernels.counts()["gather_src"] == 0

    def failing():
        _kernels.launch("gather_src", variant="float32")
        raise ValueError("the step failed")

    graph = _Graph(fake_card)
    with pytest.raises(ValueError, match="the step failed"):
        capture(graph, stream, failing)
    assert graph.calls == [("begin", "thread_local"), "end"]
    assert not _kernels._capture_tallies and _kernels.counts()["gather_src"] == 0


def test_graph_book_counts_each_tally_times_its_replays():
    book = GraphBook()
    a = book._record(Tally({"sample_tiled": 3, "masked_mean": 3}, 9, 0.01))
    b = book._record(Tally({"masked_mean": 2}, 4, 0.02))
    a.replays, b.replays = 5, 2
    assert book.replayed_launches() == {"sample_tiled": 15, "masked_mean": 19}
    book.reset_replays()
    assert book.replayed_launches() == {"sample_tiled": 0, "masked_mean": 0}
    assert GraphBook.pool_bytes([]) == 0
