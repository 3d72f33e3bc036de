"""The control on the card, at a size a test run holds: the program's own
fp8 rows (one precision below the bf16 the configuration states) must come
out not correct, and the sound program correct. Run on a card with
``python3 -m pytest perfbench/tests -m chip``."""

import pytest
import torch

from perfbench import calibrate, check
from perfbench.tests.tiny import CASES, CELL, tiny

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CASES))
def test_control_fails_and_sound_passes(card, case):
    config, mix, limits = tiny(case)
    for seed in SEEDS:
        sound = calibrate.readings(CELL, seed, "sound", card, config=config, mix=mix, limits=limits, warmup_iters=8)
        control = calibrate.readings(CELL, seed, "control", card, config=config, mix=mix, limits=limits,
                                     warmup_iters=8)
        assert not check.judge(control, limits)[0], control
        assert check.judge(sound, limits)[0], sound
