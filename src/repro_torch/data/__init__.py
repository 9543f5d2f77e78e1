from .datasets import load_cifar10, load_dataset, load_mnist  # noqa: F401
from .pipeline import FederatedData, make_federated_data, sample_batches  # noqa: F401
from .synthetic import Dataset, synthetic_cifar10, synthetic_mnist  # noqa: F401
