"""Deterministic seed registry (counterpart of orcai_tpu/utils/seeds.py).

The purpose-scoped seed ids combine with the project's master seed as
[SEED_ID, master_seed] and feed np.random.default_rng, so every shuffle of
the data pipeline is numpy's and equals the reference's to the index.
"""

from __future__ import annotations

import numpy as np

SEED_ID_MAKE_SNIPPET_TABLE = 1
SEED_ID_FILTER_SNIPPET_TABLE = 2
SEED_ID_CREATE_DATALOADER = {"train": 3, "val": 4, "test": 5, "unfiltered_test": 6}
SEED_ID_LOAD_TRAIN_DATA = 7
SEED_ID_LOAD_VAL_DATA = 8
SEED_ID_LOAD_TEST_DATA = 9
SEED_ID_UNFILTERED_TEST_DATA = 10
SEED_ID_LOAD_UNFILTERED_TEST_DATA = 11

# Sentinel marking label entries as "presence not possible". Loss and
# metrics exclude these positions.
MASK_VALUE = -1.0


def rng_for(seed_id: int, master_seed: int | None) -> np.random.Generator:
    """A numpy Generator scoped to one pipeline purpose; an unseeded one
    when the project has no master seed."""
    if master_seed is None:
        return np.random.default_rng()
    return np.random.default_rng(seed=[seed_id, master_seed])


def shuffle_seed_from(seed: int | list[int] | None) -> int:
    """A 32-bit shuffle seed from a composed seed list: the first state
    word of a SeedSequence over it."""
    return int(np.random.SeedSequence(seed).generate_state(1)[0])
