"""In-process beacon-node API for validator clients (port of
consensus_specs_tpu/api/): the endpoints a validator client needs, served
straight off a (spec, state) pair with no HTTP stack."""
from .beacon_node import ApiError, BeaconNodeAPI, SyncingStatus  # noqa: F401
