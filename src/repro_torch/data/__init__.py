"""Synthetic dataset stand-ins and federated partitioners (numpy)."""
from repro_torch.data.datasets import (CIFAR10, FASHION_MNIST, MNIST, SPECS,
                                       DatasetSpec, make_dataset,
                                       make_lm_tokens)
from repro_torch.data.federated import (client_batches, dirichlet, iid,
                                        noniid_label_k)

__all__ = ["CIFAR10", "FASHION_MNIST", "MNIST", "SPECS", "DatasetSpec",
           "make_dataset", "make_lm_tokens", "client_batches", "dirichlet",
           "iid", "noniid_label_k"]
