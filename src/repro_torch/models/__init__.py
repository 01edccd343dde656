"""Image classifiers of the FedPAE bench."""
