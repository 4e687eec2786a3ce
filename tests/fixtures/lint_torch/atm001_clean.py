"""Clean twin of ATM001: the sum by index as a one-hot product (a fixed
order on every run); an allow with its reason on a path not held
bitwise."""
import torch


def node_sums(messages, dst, n_nodes):
    onehot = torch.nn.functional.one_hot(dst, n_nodes).to(messages.dtype)
    return onehot.T @ messages


def yardstick(messages, dst, n_nodes):
    out = torch.zeros((n_nodes, messages.shape[1]), device=messages.device)
    # lint: allow(ATM001): timed beside the kernel, on no path of the port
    return out.index_add_(0, dst, messages)
