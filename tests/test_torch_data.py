"""The port's token stream and prefetch (``repro_torch.data.pipeline``,
``core.host_offload.DoubleBuffer``) against the reference's, on the CPU.

The reference's ``tests/test_data.py`` ported, then parity: batch ``i``
of the port's ``TokenStream`` is the reference's bit for bit for every
kind of stream (``synthetic``, ``zipf``, ``file``), and so are
``global_batch_indices``.  The prefetch's overlap is shown by the order
of events (the producer makes element i + 1 while the consumer holds
element i), not by wall time.
"""
import threading

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.core.host_offload import DoubleBuffer
from repro_torch.data.pipeline import (DataConfig, TokenStream,
                                       global_batch_indices)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                           # pragma: no cover
    HAVE_HYPOTHESIS = False


# ------------------------------------------- the reference's unit tests
def test_stream_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=16, micro_batch=4, seed=7)
    s1, s2 = TokenStream(cfg), TokenStream(cfg)
    for i in (0, 5, 1 << 20):
        b1, b2 = s1.batch(i), s2.batch(i)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(s1.batch(0)["tokens"],
                              s1.batch(1)["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=50, seq_len=8, micro_batch=2)
    b = TokenStream(cfg).batch(3)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


if HAVE_HYPOTHESIS:
    @given(step=st.integers(0, 1000), accum=st.integers(1, 16),
           split=st.integers(0, 16))
    @settings(max_examples=100, deadline=None)
    def test_group_indices_disjoint_complete_and_the_references(
            step, accum, split):
        k1 = min(split, accum)
        k2 = accum - k1
        r1 = global_batch_indices(step, accum, 0, k1)
        r2 = global_batch_indices(step, accum, k1, k2)
        ids = list(r1) + list(r2)
        assert len(ids) == len(set(ids)) == accum
        assert min(ids) == step * accum
        assert max(ids) == step * accum + accum - 1
        assert r1 == jpipe.global_batch_indices(step, accum, 0, k1)
        assert r2 == jpipe.global_batch_indices(step, accum, k1, k2)


def test_double_buffer_order_and_error():
    assert list(DoubleBuffer(iter(range(10)))) == list(range(10))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = iter(DoubleBuffer(bad()))
    assert next(it) == 1
    with pytest.raises(RuntimeError):
        list(it)


def test_prefetch_overlaps():
    """While the consumer holds element i, the producer has already
    made element i + 1 (the queue's depth ahead): the order of events
    shows the overlap, independent of timing."""
    events, lock = [], threading.Lock()
    made = {i: threading.Event() for i in range(4)}

    def gen():
        for i in range(4):
            with lock:
                events.append(("made", i))
            made[i].set()
            yield i

    for x in DoubleBuffer(gen()):
        if x + 1 < 4:
            # the producer runs ahead without the consumer asking
            assert made[x + 1].wait(10.0)
        with lock:
            events.append(("used", x))
    for i in range(3):
        assert events.index(("made", i + 1)) < events.index(("used", i))


def test_prefetch_thread_is_named_for_the_leak_check():
    """An undrained buffer's producer stays blocked on its queue: its
    name must not be one the suite's leak check joins."""
    buf = DoubleBuffer(iter(range(100)), depth=1)
    assert buf._t.daemon and buf._t.name == "prefetch"


# ------------------------------------------------------------- parity
def _pair(**kw):
    return (TokenStream(DataConfig(**kw)),
            jpipe.TokenStream(jpipe.DataConfig(**kw)))


@pytest.mark.parametrize("kind", ["synthetic", "zipf"])
def test_batches_equal_the_references(kind):
    mine, ref = _pair(vocab_size=512, seq_len=32, micro_batch=4, seed=3,
                      kind=kind)
    for i in (0, 1, 7, 1 << 30):
        a, b = mine.batch(i), ref.batch(i)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_file_stream_equals_the_references(tmp_path):
    path = tmp_path / "tokens.u32"
    rng = np.random.default_rng(0)
    rng.integers(0, 1000, 5000, dtype=np.uint32).tofile(path)
    mine, ref = _pair(vocab_size=1000, seq_len=16, micro_batch=3,
                      kind="file", path=str(path))
    for i in (0, 1, 50, 1234):
        a, b = mine.batch(i), ref.batch(i)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetched_stream_equals_batches():
    cfg = DataConfig(vocab_size=64, seq_len=8, micro_batch=2)
    s = TokenStream(cfg)
    it = iter(s.prefetched(5))
    for i in range(5, 9):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"], s.batch(i)["tokens"])
