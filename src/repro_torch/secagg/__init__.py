"""Sparse-mask secure aggregation's control plane: the Bonawitz-style round
protocol over DH pair secrets and Shamir shares."""
from repro_torch.secagg.protocol import RoundProtocol, ThresholdError
from repro_torch.secagg.shamir import PRIME, reconstruct, share

__all__ = ["RoundProtocol", "ThresholdError", "PRIME", "reconstruct", "share"]
