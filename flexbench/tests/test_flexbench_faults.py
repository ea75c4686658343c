"""Each fault a cell can have, planted under the timed path, makes
`correct` come out false: the harness's look for a card is skipped and
the rest of a run is driven at CPU size.

Solar (one chip, no state carried between requests): an answer altered
where it is produced (one flipped word of a block; one checksum off),
half the batch left out (half the LBAs read, the rest repeated), and a
response left unchanged from the request before. No cell runs on more
than one chip, so none has an exchange between chips to leave out."""
import pytest
import torch

from repro_torch.core.solar import SolarBlockStore
from flexbench.tests.helpers import cpu_run

SOLAR = "solar.randread.c128qd32"


def flip_word(data, crc, _):
    data = data.clone()
    data.view(torch.int32)[0, 7] ^= 1
    return data, crc


def checksum_off(data, crc, _):
    crc = crc.clone()
    crc[-1] += 1e-2
    return data, crc


def half_left_out(data, crc, _):
    h = data.shape[0] // 2
    return torch.cat([data[:h], data[:data.shape[0] - h]]), \
        torch.cat([crc[:h], crc[:crc.shape[0] - h]])


def unchanged(data, crc, prev):
    return prev if prev is not None else (data, crc)


@pytest.mark.parametrize("fault", [flip_word, checksum_off, half_left_out,
                                   unchanged])
def test_a_planted_solar_fault_is_not_correct(cpu, capsys, monkeypatch,
                                              fault):
    orig = SolarBlockStore.read_flexins
    last = [None]

    def broken(self, lbas):
        data, crc = orig(self, lbas)
        out = fault(data, crc, last[0])
        last[0] = (data, crc)
        return out
    monkeypatch.setattr(SolarBlockStore, "read_flexins", broken)
    rc, res, _ = cpu_run(capsys, SOLAR)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["words_differing"]["value"] > 0 or \
        res["checks"]["crc_gap"]["value"] > res["checks"]["crc_gap"]["limit"]
