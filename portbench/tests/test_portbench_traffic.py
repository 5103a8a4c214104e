"""The traffic generator: a seed fixes the work, and seeds differ in
order and content but not in amount."""

import collections

import numpy as np
import pytest

from portbench import generator


@pytest.mark.parametrize("mix", ["offline_test_clean", "train_clean100"])
def test_same_seed_same_batches_and_pcm(mix):
    m = generator.load_mix(mix)
    seed = 2**31 + 17
    a, b = generator.make_batches(m, seed), generator.make_batches(m, seed)
    assert a == b
    small = {**m, "pool_s": 5}
    assert np.array_equal(generator.pcm_pool(small, seed), generator.pcm_pool(small, seed))
    assert generator.place(a, 80000 * 16, seed) == generator.place(b, 80000 * 16, seed)


@pytest.mark.parametrize("mix", ["offline_test_clean"])
def test_other_seed_other_batches_same_amount(mix):
    m = generator.load_mix(mix)
    a, b = generator.make_batches(m, 1), generator.make_batches(m, 2)
    assert a != b
    assert sorted(map(sorted, (x["lengths"] for x in a))) == \
        sorted(map(sorted, (x["lengths"] for x in b)))
    small = {**m, "pool_s": 5}
    assert not np.array_equal(generator.pcm_pool(small, 1), generator.pcm_pool(small, 2))


def test_offline_batches_fill_one_bucket_each():
    m = generator.load_mix("offline_test_clean")
    batches = generator.make_batches(m, 9)
    assert len(batches) == m["cycle"]
    for b in batches:
        assert len(b["lengths"]) == m["batch"]
        assert {generator.bucket_frames(n, m["frame_bucket"]) for n in b["lengths"]} == \
            {b["frames"]}
        assert min(b["lengths"]) >= m["lengths"]["min_s"] * 16000
        assert max(b["lengths"]) <= m["lengths"]["max_s"] * 16000
    mean_s = np.mean([n for b in batches for n in b["lengths"]]) / 16000
    assert abs(mean_s - m["lengths"]["mean_s"]) < 0.3
    frames = collections.Counter(b["frames"] for b in batches)
    assert frames.most_common(1)[0][0] in (400, 600)     # the median, ~5.8 s


def test_seeds_past_32_bits_and_negative():
    m = generator.load_mix("offline_test_clean")
    for seed in (0, 2**31 + 1, 2**40, -5):
        assert len(generator.make_batches(m, seed)) == m["cycle"]


def test_training_batches_are_dealt_at_random():
    """A shuffled epoch: every seed deals the same pooled lengths, each
    batch pads to its own longest row, and the padding varies from batch
    to batch and from seed to seed."""
    m = generator.load_mix("train_clean100")
    a, b = generator.make_batches(m, 3), generator.make_batches(m, 4)
    assert len(a) == m["cycle"] and all(len(x["lengths"]) == m["batch"] for x in a)
    for x in a:
        assert x["frames"] == generator.bucket_frames(max(x["lengths"]), m["frame_bucket"])
    assert sorted(n for x in a for n in x["lengths"]) == sorted(n for x in b for n in x["lengths"])
    assert len({x["frames"] for x in a}) >= 3
    assert sorted(x["frames"] for x in a) != sorted(x["frames"] for x in b)
    mean_s = np.mean([n for x in a for n in x["lengths"]]) / 16000
    assert abs(mean_s - m["lengths"]["mean_s"]) < 0.3
