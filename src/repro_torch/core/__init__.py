"""Protocol math of the port: schedules, masks, the stream engine, costs and
the round (``fedavg``). Re-exports the ported part of ``repro.core``'s
public surface: every name below exists in the port."""
from repro_torch.core.types import (
    CommRecord,
    FedConfig,
    SecureAggConfig,
    SparseStream,
    THGSConfig,
    tree_size,
    tree_zeros_like,
)
from repro_torch.core.schedules import layer_rates, leaf_ks, round_rate
from repro_torch.core.sparsify import (densify, first_occurrence_mask,
                                       member_of, sparsify_leaf)
from repro_torch.core.masks import dh_agree, dh_private, dh_public, pair_seed
from repro_torch.core.fedavg import (FederatedState, batched_client_update,
                                     client_update, init_state, run_round)
from repro_torch.core import costs
from repro_torch.core import streams
from repro_torch.core.streams import (StreamBatch, decode_leaf_batch,
                                      dropout_cancel_streams,
                                      dropout_cancel_streams_seeded,
                                      encode_leaf_batch,
                                      mask_streams_all_pairs,
                                      pair_key_matrix, pair_seed_matrix)
from repro_torch.core.secure_agg import (aggregate_streams,
                                         dense_masked_update, encode_leaf,
                                         encode_update)
from repro_torch.core.blocked import (BlockedStream, decode_blocked_sum,
                                      encode_leaf_blocked,
                                      sharding_aligned_transform)

__all__ = [
    "CommRecord", "FedConfig", "SecureAggConfig", "SparseStream", "THGSConfig",
    "tree_size", "tree_zeros_like", "layer_rates", "leaf_ks", "round_rate",
    "densify", "first_occurrence_mask", "member_of", "sparsify_leaf",
    "dh_agree", "dh_private", "dh_public", "pair_seed",
    "FederatedState", "batched_client_update", "client_update", "init_state",
    "run_round", "costs", "streams", "StreamBatch", "decode_leaf_batch",
    "dropout_cancel_streams", "dropout_cancel_streams_seeded",
    "encode_leaf_batch", "mask_streams_all_pairs", "pair_key_matrix",
    "pair_seed_matrix", "aggregate_streams", "dense_masked_update",
    "encode_leaf", "encode_update", "BlockedStream", "decode_blocked_sum",
    "encode_leaf_blocked", "sharding_aligned_transform",
]
