"""Phase-0 beacon chain (port of consensus_specs_tpu/models/phase0/).

    from consensus_specs_tpu_torch.models import phase0
    spec = phase0.get_spec("minimal", device="cpu")
    spec.state_transition(state, block)
"""
from .spec import Phase0Spec, get_spec  # noqa: F401
