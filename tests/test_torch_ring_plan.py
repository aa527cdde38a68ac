"""The ring hop's plan (K3/K4a/K4b), without a card.

``kernels.halo_ring.hop_plan`` decides the launches of one hop from the
ranks' cards and streams: one store launch per source card, one segment
per rank, and waits only where the landing buffer is read on another
stream than the one that stores it.  These tests pin it with fake card and
stream identities, along with the landing-slot layout, the blocks per
segment, the completion-word counters and the launch tables' byte layout
(which must match ``csrc/halo_ring.cu``).
"""

import ctypes

import pytest

from unmicst_tpu_torch.kernels import halo_ring as hr


def _k3(cards):
    """K3's streams: every card stores on, and reads on, its current one."""
    cur = {c: ("cur", c) for c in cards}
    return cur, cur


def _k4(cards):
    """K4a's streams: stores on a side stream per card, reads on the
    current one."""
    return ({c: ("side", c) for c in cards}, {c: ("cur", c) for c in cards})


@pytest.mark.parametrize("n,shift", [(1, 1), (2, -1), (4, 1), (4, -1),
                                     (8, 1), (8, 3)])
def test_one_card_is_one_store_launch_with_a_segment_per_rank(n, shift):
    cards = ["gpu0"] * n
    for streams, waited in ((_k3(cards), False), (_k4(cards), True)):
        plan = hr.hop_plan(cards, shift, 6389760 // 4, *streams)
        assert len(plan.stores) == 1
        (launch,) = plan.stores
        assert launch.card == "gpu0"
        assert launch.stream == streams[0]["gpu0"]
        assert launch.segments == tuple((j, (j + shift) % n)
                                        for j in range(n))
        assert launch.signal == (waited,) * n
        assert plan.events == ()
        if waited:  # K4b: one wait launch, one lane per rank
            assert [w.card for w in plan.waits] == ["gpu0"]
            assert sorted(plan.waits[0].words) == sorted(
                ((j + shift) % n, j) for j in range(n))
        else:  # K3 on one card: stream order publishes every slot
            assert plan.waits == ()


def test_store_launches_group_by_source_card():
    cards = ["a", "a", "b", "b", "c"]  # rank 4 alone on card c
    plan = hr.hop_plan(cards, 1, 1000, *_k3(cards))
    assert [s.card for s in plan.stores] == ["a", "b", "c"]
    assert [s.segments for s in plan.stores] == [
        ((0, 1), (1, 2)), ((2, 3), (3, 4)), ((4, 0),)]
    # segments that stay on their card need no wait under K3; the three
    # that cross a card do, each on its destination's stream
    assert [s.signal for s in plan.stores] == [
        (False, True), (False, True), (True,)]
    assert {(w.card, w.words) for w in plan.waits} == {
        ("b", ((2, 1),)), ("c", ((4, 3),)), ("a", ((0, 4),))}
    # a store into another card's slot waits for that card's stream (the
    # slot's allocation point); never for its own card's
    assert sorted(plan.events) == [("a", "b"), ("b", "c"), ("c", "a")]
    # every rank is a source exactly once and a destination exactly once
    segs = [s for launch in plan.stores for s in launch.segments]
    assert sorted(j for j, _ in segs) == list(range(5))
    assert sorted(i for _, i in segs) == list(range(5))


def test_side_stream_joined_to_its_card_needs_events_only_across_cards():
    cards = ["a", "a", "b", "b"]
    plan = hr.hop_plan(cards, -1, 4096, *_k4(cards))
    assert all(s.signal == (True, True) for s in plan.stores)
    assert sorted(plan.events) == [("a", "b"), ("b", "a")]
    assert sorted(w.card for w in plan.waits) == ["a", "b"]


def test_waits_dropped_exactly_where_the_streams_are_one():
    """A destination that reads on the store's own stream needs no wait;
    one whose current stream differs (another stream on the same card) does."""
    cards = ["a"] * 4
    store = {"a": ("s", 1)}
    plan = hr.hop_plan(cards, 1, 64, store, {"a": ("s", 1)})
    assert plan.waits == () and plan.stores[0].signal == (False,) * 4
    plan = hr.hop_plan(cards, 1, 64, store, {"a": ("s", 2)})
    assert plan.stores[0].signal == (True,) * 4
    assert len(plan.waits) == 1 and len(plan.waits[0].words) == 4


def test_more_than_max_segments_split_into_launches():
    n = hr.MAX_SEGMENTS + 5
    cards = ["a"] * n
    plan = hr.hop_plan(cards, 1, 1 << 20, *_k4(cards))
    assert [len(s.segments) for s in plan.stores] == [hr.MAX_SEGMENTS, 5]
    assert [s.blocks for s in plan.stores] == [
        hr.blocks_per_segment(1 << 20, hr.MAX_SEGMENTS),
        hr.blocks_per_segment(1 << 20, 5)]
    assert [len(w.words) for w in plan.waits] == [hr.MAX_WAITS, 5]


@pytest.mark.parametrize("nbytes,nseg,blocks", [
    (0, 1, 1), (182, 1, 1), (hr.BLOCK_BYTES, 4, 1),
    (hr.BLOCK_BYTES + 1, 4, 2),
    (6389760 // 4, 4, 98),  # the 4096^2 output seam: 1.6 MB per rank
    (1 << 30, 4, 132), (1 << 30, 1, 528), (1 << 30, 8, 66)])
def test_blocks_per_segment(nbytes, nseg, blocks):
    b = hr.blocks_per_segment(nbytes, nseg)
    assert b == blocks
    assert b * nseg <= hr.BLOCKS_PER_SM * hr.SMS + nseg  # one wave or so


def test_counter_targets_are_epoch_times_blocks_and_wrap():
    c = hr.Counters()
    key = (hr.KINDS["start"], 1, 0)
    assert [c.advance(key, 98) for _ in range(3)] == [98, 196, 294]
    assert c.advance((hr.KINDS["input"], 1, 0), 98) == 98  # its own word
    b = 98
    c = hr.Counters()
    c.value[key] = 2**32 - 10 * b
    targets = [c.advance(key, b) for _ in range(12)]
    assert targets[9] == 0 and targets[10] == b and targets[11] == 2 * b
    # the device compares the signed 32-bit difference word - target:
    # a word one hop short of its target is behind across the wrap too
    for t_prev, t in zip(targets, targets[1:]):
        assert ((t_prev - t) % 2**32) >= 2**31  # behind: negative
        assert ((t - t_prev) % 2**32) == b


def test_landing_slots_are_padded():
    total, offsets = hr.slot_layout(182, 4)  # int16 (7, 13)
    assert offsets == [0, 256, 512, 768] and total == 1024
    assert all(o % 16 == 0 for o in offsets)
    assert hr.slot_layout(6389760 // 4, 2) == (2 * 1597440, [0, 1597440])
    assert hr.slot_layout(0, 3) == (0, [0, 0, 0])


def test_launch_tables_match_the_cuda_structs():
    """StoreArgs/WaitArgs go to the kernels by value: their layout must be
    the one csrc/halo_ring.cu declares."""
    assert ctypes.sizeof(hr._Segment) == 32
    assert ctypes.sizeof(hr._StoreArgs) == 32 * hr.MAX_SEGMENTS + 16
    assert hr._StoreArgs.nbytes.offset == 32 * hr.MAX_SEGMENTS
    assert ctypes.sizeof(hr._WaitEntry) == 16
    assert ctypes.sizeof(hr._WaitArgs) == 16 * hr.MAX_WAITS + 16
    assert hr._WaitArgs.timeout_ns.offset == 16 * hr.MAX_WAITS + 8
