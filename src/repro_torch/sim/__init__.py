"""repro_torch.sim — the port's multi-round federated simulation engine
(``python -m repro_torch.sim --preset table2_quick``)."""
from repro_torch.sim.config import SimConfig
from repro_torch.sim.engine import (AsyncSimulation, SimResult, Simulation,
                                    publish_params_hook, simulate,
                                    simulation_for)
from repro_torch.sim.ledger import CommLedger, LedgerEntry, mib
from repro_torch.sim.sampler import ClientSampler

__all__ = ["SimConfig", "SimResult", "Simulation", "AsyncSimulation",
           "simulate", "simulation_for", "publish_params_hook", "CommLedger",
           "LedgerEntry", "mib", "ClientSampler"]
