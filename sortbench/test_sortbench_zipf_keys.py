"""The Zipf maker (``datagen/zipf_keys.py``) on the CPU: its keys follow
numpy's ``Generator.zipf`` (the same sampler), are clamped to 32 bits,
come from the seed alone, a generator a chunk."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from sortbench.datagen import zipf_keys  # noqa: E402

CONFIG = json.loads((ROOT / "sortbench" / "configs" /
                     "paper-p32-zipf.json").read_text())
SEED = (1 << 33) + 29
N = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def values(keys: torch.Tensor) -> np.ndarray:
    """Unsigned key values as int64."""
    return (keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).numpy()


@pytest.fixture(scope="module")
def drawn():
    """2**20 keys of the maker's first set and 2**22 of numpy's sampler,
    clamped as the maker clamps."""
    ours = values(zipf_keys.make(CONFIG, SEED, "cpu", size=N)["keys"][0])
    theirs = np.minimum(np.random.default_rng(7).zipf(CONFIG["zipf_a"],
                                                      1 << 22),
                        zipf_keys.KEY_MAX)
    return ours, theirs


SHARES = {"key_1": lambda k: k == 1, "key_2": lambda k: k == 2,
          "key_3": lambda k: k == 3, "key_4": lambda k: k == 4,
          "at_least_2_16": lambda k: k >= 1 << 16,
          "at_least_2_24": lambda k: k >= 1 << 24}


@pytest.mark.parametrize("share", sorted(SHARES))
def test_shares_agree_with_numpy(drawn, share):
    """Within 5 binomial standard deviations of the two samples."""
    ours, theirs = drawn
    a, b = SHARES[share](ours).mean(), SHARES[share](theirs).mean()
    pooled = (a * ours.size + b * theirs.size) / (ours.size + theirs.size)
    sd = math.sqrt(pooled * (1 - pooled) * (1 / ours.size + 1 / theirs.size))
    assert abs(a - b) <= 5 * sd, (share, a, b, sd)


def test_clamped_share_is_about_one_percent(drawn):
    ours, _ = drawn
    assert ours.max() == zipf_keys.KEY_MAX
    assert 0.009 <= (ours == zipf_keys.KEY_MAX).mean() <= 0.013


def test_the_seed_gives_the_keys_and_sets_differ():
    a = zipf_keys.make(CONFIG, SEED, "cpu", size=4099)["keys"]
    b = zipf_keys.make(CONFIG, SEED, "cpu", size=4099)["keys"]
    c = zipf_keys.make(CONFIG, SEED + 1, "cpu", size=4099)["keys"]
    assert len(a) == CONFIG["inputs"] == 2
    assert all(np.array_equal(values(x), values(y)) for x, y in zip(a, b))
    assert not np.array_equal(values(a[0]), values(a[1]))
    assert not np.array_equal(values(a[0]), values(c[0]))


def test_a_chunk_depends_on_the_seed_the_set_and_the_chunk(monkeypatch):
    """Over chunks of 4096 keys and a ragged last chunk: a set's first
    chunk is the whole of a one-chunk set, and its chunks differ."""
    monkeypatch.setattr(zipf_keys, "CHUNK", 4096)
    many = values(zipf_keys.make(CONFIG, SEED, "cpu",
                                 size=3 * 4096 + 5)["keys"][1])
    one = values(zipf_keys.make(CONFIG, SEED, "cpu", size=4096)["keys"][1])
    assert many.shape == (3 * 4096 + 5,)
    assert np.array_equal(many[:4096], one)
    chunks = [many[c:c + 4096] for c in range(0, 3 * 4096, 4096)]
    assert not any(np.array_equal(x, y) for x, y in zip(chunks, chunks[1:]))


def test_dtype_size_and_p_checks():
    data = zipf_keys.make(CONFIG, SEED, "cpu", size=777)
    assert data["p"] == 32
    assert all(k.dtype == torch.uint32 and k.shape == (777,)
               for k in data["keys"])
    assert values(data["keys"][0]).min() >= 1
    with pytest.raises(ValueError):
        zipf_keys.make(dict(CONFIG, p=16), SEED, "cpu", size=777)
