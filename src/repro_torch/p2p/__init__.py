"""Simulated peer-to-peer substrate: transport links, gossip protocol,
client churn, and anti-entropy repair (DESIGN.md §6, §8), ported from
`repro/p2p`. The async scheduler composes these."""
from repro_torch.p2p.churn import ChurnConfig, ChurnSchedule
from repro_torch.p2p.gossip import (GossipConfig, GossipProtocol,
                                    GossipStats)
from repro_torch.p2p.repair import (AntiEntropyRepair, RepairConfig,
                                    RepairStats, digest_nbytes, repair_rng)
from repro_torch.p2p.transport import (DIGEST_OWNER, GossipTransport,
                                       TransportConfig, TransportStats,
                                       checkpoint_bytes, edge_rng,
                                       prediction_matrix_bytes)

__all__ = [
    "AntiEntropyRepair", "RepairConfig", "RepairStats",
    "ChurnConfig", "ChurnSchedule",
    "DIGEST_OWNER",
    "GossipConfig", "GossipProtocol", "GossipStats",
    "GossipTransport", "TransportConfig", "TransportStats",
    "checkpoint_bytes", "digest_nbytes", "edge_rng",
    "prediction_matrix_bytes", "repair_rng",
]
