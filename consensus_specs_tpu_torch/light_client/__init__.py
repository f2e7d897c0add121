"""Light-client support: multiproofs and the committee-sync protocol.

Capability parity with consensus-specs specs/light_client/
(merkle_proofs.md: generalized tree indices :26-104, multiproofs :106-165,
MerklePartial :167-187; sync_protocol.md: period data :57-96, committee
reconstruction :119-160, block validity proofs :164-199). These give light
clients O(log N) access into the beacon state — the reference's
"ring-attention equivalent" access pattern (SURVEY.md §5).

Port of consensus_specs_tpu/light_client/: the same functions over the
port's phase-1 spec and SSZ.
"""
from .multiproof import (  # noqa: F401
    MerklePartial, SSZMerkleTree, generalized_index_for_path,
    get_helper_indices, merkle_tree_nodes, verify_multiproof)
from .sync_protocol import (  # noqa: F401
    BlockValidityProof, PeriodData, ValidatorMemory, build_validator_memory,
    get_period_data, verify_block_validity_proof)
