"""SSZ: the type system, the codec and the roots (port of
consensus_specs_tpu/utils/ssz/; the same re-exports). bulk.py,
columns.py and incremental.py hold the device Merkle paths."""
from .typing import (  # noqa: F401
    Bytes, Bytes1, Bytes4, Bytes8, Bytes32, Bytes48, Bytes96,
    Container, List, Vector, byte,
    uint, uint8, uint16, uint32, uint64, uint128, uint256,
    get_zero_value, copy_value, infer_type, read_elem_type,
    is_bool_type, is_bytes_type, is_bytesn_type, is_container_type,
    is_list_kind, is_list_type, is_uint_type, is_vector_kind, is_vector_type,
    uint_byte_size,
)
from .impl import (  # noqa: F401
    serialize, deserialize, hash_tree_root, signing_root,
    serialize_basic, deserialize_basic, is_basic_type, is_fixed_size,
    fixed_byte_size, pack, chunkify, mix_in_length,
)
