"""The traffic generator: the same seed gives the same requests."""
import numpy as np

from flexbench import cells, traffic

MIX = cells.HERE / "traffic"


def test_block_reads_repeat_with_the_seed_and_stay_in_the_store():
    p = traffic.load(MIX / "randread-c128qd32.json")
    a = traffic.BlockReads(p, 1 << 20, 2 ** 33 + 5)
    b = traffic.BlockReads(p, 1 << 20, 2 ** 33 + 5)
    c = traffic.BlockReads(p, 1 << 20, 2 ** 33 + 6)
    assert a.n == 4096 and a.lbas(3).shape == (4096,)
    assert np.array_equal(a.lbas(3), b.lbas(3))
    assert not np.array_equal(a.lbas(3), c.lbas(3))
    assert a.pool.min() >= 0 and a.pool.max() < 1 << 20
    assert a.lbas(3).dtype == np.int64
    assert np.array_equal(a.lbas(3), a.lbas(3 + a.pool_size))
