// texcomp_torch host-side runtime: the memory-movement half of the
// framework.
//
// The card computes per-block math; the host moves bytes. These are the
// native equivalents of the reference's host-side loops — block-grid
// assembly for Pad (compressor4x4_helper.h:420-474), CopySubimage's
// row-wise memcpy (:569-589), CreateSolidImage's block replication
// (:536-541), the row-stride (de)interleave implied by
// padding_bytes_per_row (color_util.h:433-466), and PVRTC's Z-order
// addressing (pvrtc_compressor.cc:80-86).
//
// Exposed as a plain C ABI for ctypes. texcomp_torch/native/__init__.py
// builds it with g++ at first use and calls it for every host-side byte
// movement of the API; the numpy functions beside it there are its plain
// twins, which the tests hold it to. There is no fallback: a failed build
// raises.

#include <cstdint>
#include <cstring>

extern "C" {

// Assemble a padded block grid: copy the original grid into the top-left,
// replicate per-row column-pad blocks to the right, a padded bottom row
// below (row-pad blocks then corner-pad blocks).
void th_pad_block_grid(const uint8_t* src, uint32_t nbr, uint32_t nbc,
                       uint32_t pbr, uint32_t pbc, uint32_t bs,
                       const uint8_t* col_pad,    // nbr * bs
                       const uint8_t* row_pad,    // nbc * bs
                       const uint8_t* corner_pad, // bs
                       uint8_t* dst) {
  for (uint32_t r = 0; r < nbr; ++r) {
    uint8_t* drow = dst + static_cast<size_t>(r) * pbc * bs;
    std::memcpy(drow, src + static_cast<size_t>(r) * nbc * bs,
                static_cast<size_t>(nbc) * bs);
    for (uint32_t c = nbc; c < pbc; ++c)
      std::memcpy(drow + static_cast<size_t>(c) * bs, col_pad + r * bs, bs);
  }
  if (pbr > nbr) {
    // Build the last padded row once, then replicate it.
    uint8_t* first = dst + static_cast<size_t>(nbr) * pbc * bs;
    for (uint32_t c = 0; c < nbc; ++c)
      std::memcpy(first + static_cast<size_t>(c) * bs, row_pad + c * bs, bs);
    for (uint32_t c = nbc; c < pbc; ++c)
      std::memcpy(first + static_cast<size_t>(c) * bs, corner_pad, bs);
    for (uint32_t r = nbr + 1; r < pbr; ++r)
      std::memcpy(dst + static_cast<size_t>(r) * pbc * bs, first,
                  static_cast<size_t>(pbc) * bs);
  }
}

// Copy a sub-rectangle of a block grid (CopySubimage's hot loop).
void th_copy_subgrid(const uint8_t* src, uint32_t src_nbc, uint32_t bs,
                     uint32_t r0, uint32_t c0, uint32_t nbr, uint32_t nbc,
                     uint8_t* dst) {
  for (uint32_t r = 0; r < nbr; ++r)
    std::memcpy(dst + static_cast<size_t>(r) * nbc * bs,
                src + (static_cast<size_t>(r0 + r) * src_nbc + c0) * bs,
                static_cast<size_t>(nbc) * bs);
}

// Replicate one block n times (CreateSolidImage's loop).
void th_fill_blocks(uint8_t* dst, uint32_t n, const uint8_t* block,
                    uint32_t bs) {
  for (uint32_t i = 0; i < n; ++i)
    std::memcpy(dst + static_cast<size_t>(i) * bs, block, bs);
}

// Row-strided copy: move `rows` rows of `row_bytes` each between buffers
// with different strides (image <-> padded row buffer).
void th_strided_copy_rows(const uint8_t* src, uint8_t* dst, uint32_t rows,
                          uint32_t row_bytes, uint32_t src_stride,
                          uint32_t dst_stride) {
  for (uint32_t r = 0; r < rows; ++r)
    std::memcpy(dst + static_cast<size_t>(r) * dst_stride,
                src + static_cast<size_t>(r) * src_stride, row_bytes);
}

// Z-order block permutation: perm[i] = row-major index of Z-order slot i
// (FromZOrder, pvrtc_compressor.cc:80-86).
void th_zorder_perm(int32_t* out, uint32_t nbx, uint32_t nby) {
  const uint32_t n = nbx * nby;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t x = 0, y = 0;
    for (uint32_t j = 0; j < 16; ++j) {
      x |= ((i >> (j * 2 + 1)) & 1u) << j;
      y |= ((i >> (j * 2 + 0)) & 1u) << j;
    }
    out[i] = static_cast<int32_t>(y * nbx + x);
  }
}

// Reorder whole records by a permutation: dst[i] = src[perm[i]].
void th_permute_records(const uint8_t* src, const int32_t* perm, uint32_t n,
                        uint32_t record_bytes, uint8_t* dst) {
  for (uint32_t i = 0; i < n; ++i)
    std::memcpy(dst + static_cast<size_t>(i) * record_bytes,
                src + static_cast<size_t>(perm[i]) * record_bytes,
                record_bytes);
}

}  // extern "C"
