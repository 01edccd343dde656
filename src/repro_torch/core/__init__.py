"""FedPAE's selection system in PyTorch: objectives, NSGA-II, selection,
prediction stores, the device-resident statistics and the engine."""
