"""Block scatter: kernel K9 and its plain version.

Counterpart of the pallas_call of tools/pallas_dma_bench.py (`build`,
:43-94), the repo's DMA block-scatter measuring tool: int32 blocks of S
elements, block i of `src` copied to block offs[i] of the output.  No path
of the codec runs it; chip_smoke.py holds it against its plain version and
times it beside `index_copy_`.

block_scatter launches K9 (csrc/block_scatter.cu) for a CUDA tensor and
runs block_scatter_plain for a CPU tensor.
"""

import torch

from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("block_scatter", "jt_block_scatter",
                "jampack_tpu_torch/csrc/block_scatter.cu",
                "tools/pallas_dma_bench.py:83")


def _check(src, offs, S: int) -> int:
    if src.dtype != torch.int32 or src.dim() != 1:
        raise ValueError("src must be a 1-D int32 tensor")
    if S < 1 or src.numel() % S:
        raise ValueError("src must hold whole blocks of S >= 1 elements")
    nb = src.numel() // S
    if offs.dtype != torch.int32 or offs.shape != (nb,):
        raise ValueError("offs must be (nblocks,) int32")
    if src.device != offs.device:
        raise ValueError("all inputs must be on one device")
    return nb


def block_scatter(src: torch.Tensor, offs: torch.Tensor, S: int):
    """out[offs[i]*S:(offs[i]+1)*S] = src[i*S:(i+1)*S] for each block i.

    src: (nblocks * S,) int32; offs: (nblocks,) int32, a permutation of
    range(nblocks) (a block that no index names is left unwritten).
    Returns out, shaped and typed as src."""
    nb = _check(src, offs, S)
    if not src.is_cuda:
        return block_scatter_plain(src, offs, S)
    out = torch.empty(src.numel(), dtype=torch.int32, device=src.device)
    if nb == 0:
        return out
    src, offs = src.contiguous(), offs.contiguous()
    KERNEL.launch(ptr(src), ptr(offs), nb, S, ptr(out), stream_of(src))
    return out


def block_scatter_plain(src, offs, S: int):
    """Plain PyTorch version of K9: one indexed assignment of the (nblocks,
    S) view.  Same contract as block_scatter."""
    nb = _check(src, offs, S)
    out = torch.empty(src.numel(), dtype=torch.int32, device=src.device)
    out.view(nb, S)[offs.long()] = src.reshape(nb, S)
    return out
