"""The paper's own models (Sec. VI-A.2) as selectable configs.

These are CNNs, not transformers — they are trained through the federation
simulator (repro_torch.fed.simulator), not the decoder stack. ArchConfig fields are
reinterpreted: d_model ~ feature width, num_layers ~ conv layers."""
from .base import ArchConfig

MNIST_CNN = ArchConfig(
    name="mnist-cnn",
    family="cnn",
    num_layers=2,
    d_model=50,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=320,
    vocab_size=10,
    citation="[paper Sec. VI-A.2; github.com/AshwinRJ/Federated-Learning-PyTorch] 21,840 params",
)

CIFAR_CNN = ArchConfig(
    name="cifar-cnn",
    family="cnn",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=1024,
    vocab_size=10,
    citation="[paper Sec. VI-A.2; github.com/AshwinRJ/Federated-Learning-PyTorch] 33,834 params",
)
