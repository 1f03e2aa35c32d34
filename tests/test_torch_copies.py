"""The port's copies of the jax-free modules agree with the JAX package's.

Decode masks, canonical keys, genome content hashes and genome sampling are
host-side numpy in both packages; the port keeps its own copies so it never
imports the reference.  Every comparison here is exact.
"""

import itertools

import numpy as np
import pytest

from gentun_tpu.genes import genetic_cnn_genome as ref_genome
from gentun_tpu.models.cnn import _genome_hashes as ref_hashes
from gentun_tpu.ops import dag as ref_dag
from gentun_tpu.parallel import mesh as ref_mesh
from gentun_tpu.populations import _compile_bucket as ref_bucket

from gentun_tpu_torch import populations as port_populations
from gentun_tpu_torch.genes import genetic_cnn_genome as port_genome
from gentun_tpu_torch.models.cnn import _genome_hashes as port_hashes
from gentun_tpu_torch.ops import dag as port_dag
from gentun_tpu_torch.parallel import mesh as port_mesh


def _all_genomes(nodes):
    """Every genome of a stage layout (2**bits of them)."""
    n_bits = [k * (k - 1) // 2 for k in nodes]
    for bits in itertools.product((0, 1), repeat=sum(n_bits)):
        genome, at = {}, 0
        for s, n in enumerate(n_bits):
            genome[f"S_{s + 1}"] = tuple(bits[at : at + n])
            at += n
        yield genome


def _sampled_genomes(nodes, n, seed):
    rng = np.random.default_rng(seed)
    spec = ref_genome(nodes)
    return [spec.sample(rng) for _ in range(n)]


GENOME_SETS = {
    "S=(3,) all": lambda: list(_all_genomes((3,))),
    "S=(3,5) all": lambda: list(_all_genomes((3, 5))),
    "S=(3,4,5) sample": lambda: _sampled_genomes((3, 4, 5), 200, seed=7),
}
NODES = {"S=(3,) all": (3,), "S=(3,5) all": (3, 5), "S=(3,4,5) sample": (3, 4, 5)}


@pytest.mark.parametrize("which", sorted(GENOME_SETS))
def test_masks_and_canonical_keys_equal_reference(which):
    genomes, nodes = GENOME_SETS[which](), NODES[which]
    ref = ref_dag.stack_genome_masks(genomes, nodes)
    port = port_dag.stack_genome_masks(genomes, nodes)
    assert len(ref) == len(port) == len(nodes)
    for r, p in zip(ref, port):
        assert sorted(r) == sorted(p)
        for k in r:
            assert r[k].dtype == p[k].dtype
            np.testing.assert_array_equal(r[k], p[k])
    # The reference's key is the tuple of its per-stage canonical bits; memoise
    # those per stage so the reference side costs one call per distinct stage.
    ref_stage = {}
    for g in genomes:
        want = []
        for s, k in enumerate(nodes):
            bits = tuple(g[f"S_{s + 1}"])
            if (k, bits) not in ref_stage:
                ref_stage[k, bits] = ref_dag.canonical_key({"S_1": bits}, (k,))[0]
            want.append(ref_stage[k, bits])
        assert port_dag.canonical_key(g, nodes) == tuple(want)


@pytest.mark.parametrize("which", sorted(GENOME_SETS))
def test_genome_hashes_bit_equal(which):
    genomes = GENOME_SETS[which]()
    r, p = ref_hashes(genomes), port_hashes(genomes)
    assert p.dtype == r.dtype == np.uint32
    np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("nodes", [(3,), (3, 5), (3, 4, 5)])
def test_genome_sampling_equal_under_one_seed(nodes):
    ref_rng, port_rng = np.random.default_rng(11), np.random.default_rng(11)
    ref_spec, port_spec = ref_genome(nodes), port_genome(nodes)
    for _ in range(25):
        assert port_spec.sample(port_rng) == ref_spec.sample(ref_rng)


def test_population_helpers_equal_reference():
    for n in range(0, 40):
        assert port_mesh.pop_bucket(n) == ref_mesh.pop_bucket(n) == ref_bucket(n)
        assert port_populations._compile_bucket(n) == ref_bucket(n)
    genomes = [{"S_1": (i % 2, 0, 1)} for i in range(5)]
    for multiple in (1, 2, 4, 8):
        assert port_mesh.pad_population(genomes, multiple) == ref_mesh.pad_population(genomes, multiple)
    for cfg in [((3,), (8,), (8, 8, 1), 32, 4, "float32", False),
                ((3, 4, 5), (32, 64, 128), (32, 32, 3), 256, 10, "bfloat16", True)]:
        cost = port_mesh.cnn_genome_cost(*cfg)
        assert tuple(cost) == tuple(ref_mesh.cnn_genome_cost(*cfg))
        for budget in (10**6, 10**8, 10**10):
            for batch in (1, 64, 256):
                try:
                    want = ref_mesh.classify_genome_cost(cost, batch, 1, budget)
                except ValueError:
                    with pytest.raises(ValueError):
                        port_mesh.classify_genome_cost(cost, batch, 1, budget)
                    continue
                assert port_mesh.classify_genome_cost(cost, batch, 1, budget) == want
