"""Genomes and data repeat exactly from a seed, and differ between seeds."""

import numpy as np
import pytest

from benchmark import data, genomes
from benchmark.tests.conftest import TINY

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


@pytest.mark.parametrize("seed", SEEDS)
def test_genomes_repeat_from_a_seed(seed):
    a = genomes.sample_genomes([3, 4, 5], 20, seed, 1)
    assert a == genomes.sample_genomes([3, 4, 5], 20, seed, 1)
    assert a != genomes.sample_genomes([3, 4, 5], 20, seed, 2)
    assert a != genomes.sample_genomes([3, 4, 5], 20, seed + 1, 1)
    assert all(len(g["S_3"]) == 10 and set(g["S_3"]) <= {0, 1} for g in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_images_repeat_from_a_seed(seed):
    x, y = data.images(TINY, seed)
    x2, y2 = data.images(TINY, seed)
    assert x.dtype == np.float32 and x.shape == (256, 8, 8, 3) and y.shape == (256,)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert not np.array_equal(x, data.images(TINY, seed + 1)[0])
    assert 0 <= data.model_seed(seed) < 2**63


def test_decode_follows_the_papers_rules():
    # a stage of 4: edges 0→2, 1→2 (bits 1 and 2), node 3 isolated
    st = genomes.decode_stage((0, 1, 1, 0, 0, 0), 4)
    assert st.active == (True, True, True, False)
    assert st.entry == (True, True, False, False)
    assert st.exit == (False, False, True, False)
    assert st.sources(2) == [0, 1] and st.successors(0) == [2]


def test_the_content_hash_and_stream_seed_match_the_systems():
    from gentun_tpu_torch.models import cnn

    gs = genomes.sample_genomes([3, 4, 5], 5, 42, 1)
    assert [genomes.genome_hash(g) for g in gs] == [tuple(int(v) for v in h)
                                                    for h in cnn._genome_hashes(gs)]
    assert genomes.stream_seed(1, 2, 3) == cnn._stream_seed(1, 2, 3)
    assert genomes.INIT_DOMAIN == cnn._INIT_DOMAIN
