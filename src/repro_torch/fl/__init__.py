"""Federated clients: local training, inference and topologies."""
