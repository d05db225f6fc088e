"""The paper's own MNIST MLP (784 -> 512 -> 512 -> 10, ReLU, DropoutNeuron;
paper §3).  Built through the neuron-centric API; registered here so
``--arch horn-mnist`` selects the paper-faithful experiment."""
from repro_torch.configs.base import ATTN, ModelConfig, register
from repro_torch.core.neuron_centric import paper_mnist_network

CONFIG = register(ModelConfig(
    name="horn-mnist", family="mlp",
    num_layers=2, d_model=512, num_heads=1, num_kv_heads=1, head_dim=1,
    d_ff=512, vocab_size=10, use_rope=False, tie_embeddings=True,
    layer_pattern=(ATTN,),
))


def network(hidden: int = 512, depth: int = 2):
    return paper_mnist_network(hidden=hidden, depth=depth)
