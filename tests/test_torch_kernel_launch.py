"""The Python around the port's kernel launches, on the CPU.

- ``tensor_map_layout``: the 4-D TMA tensor map the bf16 flash kernels
  (K3, K4, K5) read a strided ``[B, N, H, 64]`` view through, against
  values computed by hand for the q, k and v views that ``ElasticMHA`` takes
  from the fused qkv projection (``qkv.unbind(2)``) at 6, 9 and 12 heads;
  strides that TMA cannot take raise. At N = 129 the forward's q view has
  a second 128-row block with one real row: the map's row dimension is N, so
  the 63 rows a box reads past it arrive as zeros.
- ``build.library_path``: the library name changes when a shared header
  ``csrc/*.cuh`` changes, so an edited header rebuilds.
- ``build.kernel_name``: a device function's name and integer or builtin
  type template arguments out of the mangled name ptxas prints.
"""
import pytest
import torch

from gaiaseg_tpu_torch.ops.cuda import build
from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa


@pytest.mark.parametrize("heads", [6, 9, 12])
def test_tensor_map_layout_of_qkv_views(heads):
    b, n = 2, 1025
    qkv = torch.zeros(b, n, 3, heads, 64, dtype=torch.bfloat16)
    token = 3 * heads * 64 * 2            # bytes from one token to the next
    for t in qkv.unbind(2):
        dims, strides, box = fa.tensor_map_layout(t)
        assert dims == (64, heads, n, b)
        assert strides == (128, token, n * token)
        assert box == (64, 1, 64, 1)
    # q after the scale is a contiguous [B, N, H, 64] tensor
    dims, strides, _ = fa.tensor_map_layout(qkv[:, :, 0] * 0.125)
    assert dims == (64, heads, n, b)
    assert strides == (128, heads * 128, n * heads * 128)


def test_tensor_map_layout_of_forward_q_view_at_129_tokens():
    """The forward's q operand as ElasticMHA hands it over at N = 129: the
    q view of the fused qkv, and the contiguous tensor the scale makes of
    it; the map must state N itself (not N rounded up to a tile), since the
    kernel relies on TMA's zero fill past row N."""
    b, n, heads = 2, 129, 12
    qkv = torch.zeros(b, n, 3, heads, 64, dtype=torch.bfloat16)
    token = 3 * heads * 64 * 2
    q_view = qkv.unbind(2)[0]
    assert fa.tensor_map_layout(q_view) == (
        (64, heads, n, b), (128, token, n * token),
        (64, 1, fa.TILE_ROWS, 1))
    assert fa.tensor_map_layout(q_view * 0.125) == (
        (64, heads, n, b), (128, heads * 128, n * heads * 128),
        (64, 1, fa.TILE_ROWS, 1))
    assert -(-n // 128) == 2 and n - 128 == 1     # one real row in block 1


def test_tensor_map_layout_raises_on_strides_tma_cannot_take():
    wide = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16)
    assert fa.tensor_map_layout(wide[..., :64])[1] == (144, 288, 8 * 288)
    padded = torch.zeros(1, 8, 2, 68, dtype=torch.float32)
    fa.tensor_map_layout(padded[..., :64])       # 272 bytes: fine
    odd = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # 136 bytes
        fa.tensor_map_layout(odd[..., :64])
    flat = torch.zeros(1 * 8 * 2 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # base 8 bytes past an aligned one
        fa.tensor_map_layout(flat[4:].view(1, 8, 2, 64))
    with pytest.raises(ValueError):     # head dim not contiguous
        fa.tensor_map_layout(torch.zeros(1, 8, 64, 2).transpose(2, 3))


def test_library_path_covers_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    header.write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.parent == build.BUILD_DIR
    (tmp_path / "other.cuh").write_text("")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k").name.startswith("libk_")


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_18fwd_tileILi19EEEvPKfPKiPjPfiiiii", "fwd_tile<19>"),
    ("_ZN12_GLOBAL__N_112fwd_tile_anyEPKfPKiPjPfiiiiii", "fwd_tile_any"),
    ("_ZN12_GLOBAL__N_112bwd_tile_anyILi8ELi20ELi2EEEvPKfPKiS2_Pfiiiiiibi",
     "bwd_tile_any<8, 20, 2>"),
    ("_Z9fwd_wgmmaPKv", "fwd_wgmma"),
    ("_ZN12_GLOBAL__N_113window_countsIhEEvPKT_PKxS4_PKhPyiiiiiiix",
     "window_counts<unsigned char>"),
    ("_ZN12_GLOBAL__N_113window_countsIxEEvPKT_PKxS4_PKhPyiiiiiiix",
     "window_counts<long long>")])
def test_kernel_name_from_mangled(mangled, name):
    assert build.kernel_name(mangled) == name
