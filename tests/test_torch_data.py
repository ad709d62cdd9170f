"""The port's LM data stream and batch placement (`repro_torch.data`)
against `repro.data`, on the CPU: the same seed gives the same numpy
arrays, bit for bit (tests/test_data.py's LM cases, held to the
reference)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.data import LMTaskConfig as JLMTaskConfig
from repro.data import lm_batches as jlm_batches
from repro_torch.data import LMTaskConfig, lm_batches, shard_batch
from repro_torch.launch.mesh import make_test_mesh


@pytest.mark.parametrize("seed", [0, 3])
def test_lm_batches_bit_identical_to_reference(seed):
    kw = dict(vocab_size=151936, seq_len=24, batch_size=5, seed=seed)
    jgen, gen = jlm_batches(JLMTaskConfig(**kw)), lm_batches(
        LMTaskConfig(**kw))
    for _ in range(5):
        want, got = next(jgen), next(gen)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_lm_batches_learnable_structure():
    gen = lm_batches(LMTaskConfig(vocab_size=50, seq_len=12, batch_size=4,
                                  noise=0.0, num_rules=2, seed=1))
    b = next(gen)
    assert b["tokens"].shape == (4, 12) and b["labels"].shape == (4, 12)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b2 = next(gen)
    assert b2["tokens"].max() < 50 and b2["tokens"].min() >= 0


def test_shard_batch_puts_the_batch_on_a_device_or_a_mesh():
    b = next(lm_batches(LMTaskConfig(vocab_size=64, seq_len=8,
                                     batch_size=2)))
    for target in ("cpu", make_test_mesh(2, 1, "cpu")):
        out = shard_batch(b, target)
        for k, v in b.items():
            assert out[k].device.type == "cpu"
            np.testing.assert_array_equal(out[k].numpy(), v)
    if not torch.cuda.is_available():       # the CUDA device by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_batch(b, None)
