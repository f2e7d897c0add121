"""Phase-1 protocol constants (own copy of
consensus_specs_tpu/models/phase1/constants.py).

Custody game tables: consensus-specs specs/core/1_custody-game.md:74-113;
shard chain tables: specs/core/1_shard-data-chains.md:41-66. Held as one
dict Phase1Spec splats onto itself (phase-0 constants come from the preset
YAMLs; these are phase-global in the 2019 spec, not preset-varied).
"""

CUSTODY_CONSTANTS = {
    # misc
    "BYTES_PER_SHARD_BLOCK": 2 ** 14,
    "BYTES_PER_CUSTODY_CHUNK": 2 ** 9,
    "MINOR_REWARD_QUOTIENT": 2 ** 8,
    # time
    "MAX_CHUNK_CHALLENGE_DELAY": 2 ** 11,
    "CUSTODY_RESPONSE_DEADLINE": 2 ** 14,
    "RANDAO_PENALTY_EPOCHS": 2 ** 1,
    "EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS": 2 ** 14,
    "EPOCHS_PER_CUSTODY_PERIOD": 2 ** 11,
    "CUSTODY_PERIOD_TO_RANDAO_PADDING": 2 ** 11,
    "MAX_REVEAL_LATENESS_DECREMENT": 2 ** 7,
    # max operations per block
    "MAX_CUSTODY_KEY_REVEALS": 2 ** 4,
    "MAX_EARLY_DERIVED_SECRET_REVEALS": 1,
    "MAX_CUSTODY_CHUNK_CHALLENGES": 2 ** 2,
    "MAX_CUSTODY_BIT_CHALLENGES": 2 ** 2,
    "MAX_CUSTODY_RESPONSES": 2 ** 5,
    # rewards
    "EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE": 2 ** 1,
    # domains
    "DOMAIN_CUSTODY_BIT_CHALLENGE": 6,
}

SHARD_CONSTANTS = {
    "BYTES_PER_SHARD_BLOCK_BODY": 2 ** 14,
    "MAX_SHARD_ATTESTIONS": 2 ** 4,
    "PHASE_1_FORK_EPOCH": 0,     # TBD in the reference; testing timeline value
    "PHASE_1_FORK_SLOT": 0,
    "GENESIS_SHARD_SLOT": 0,
    "CROSSLINK_LOOKBACK": 2 ** 0,
    "DOMAIN_SHARD_PROPOSER": 128,
    "DOMAIN_SHARD_ATTESTER": 129,
}

# The minimal preset shrinks STATE SHAPES only (the exposed-secrets vector
# length dominates per-slot state hashing), the same way it shrinks the
# phase-0 history vectors. Time parameters stay at spec values — shrinking
# them would make multi-epoch phase-0 scenarios trip custody deadlines that
# mainnet never hits (the deadline is ~73 days). The randao padding shrinks
# with the vector (it must stay below the vector length for the slashing
# window to be representable).
MINIMAL_OVERRIDES = {
    "EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS": 64,
    "CUSTODY_PERIOD_TO_RANDAO_PADDING": 8,
}
