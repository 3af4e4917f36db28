// Four ternary weights as packed int8 bytes, from the nibbles of a pos and
// a neg byte of the bit-plane container (formats/bitplane.py): the decode
// that both int8 bodies over TiledBitplane share, the tensor-core core
// (bitplane_mma.cuh, its B fragments) and the streaming decode body
// (gemv_core.cuh, the __dp4a operands).
#pragma once

#include <stdint.h>

namespace ternary {

// Four weights as packed int8 {-1, 0, +1}, byte j = pos bit j - neg bit j:
// the multiply spreads a nibble's bits to bit 0 of bytes 0..3; 0x80 + pos -
// neg per byte borrows across no byte, and ^0x80 makes it an int8. A byte
// pair with both flags set gives 0, as the plain version's bits(pos) -
// bits(neg) does.
__device__ __forceinline__ uint32_t ternary4(uint32_t p, uint32_t n) {
  const uint32_t sp = (p * 0x00204081u) & 0x01010101u;
  const uint32_t sn = (n * 0x00204081u) & 0x01010101u;
  return ((sp | 0x80808080u) - sn) ^ 0x80808080u;
}

// 32 w bytewise from ternary4's w: 0x01 -> 0x20, 0xFF -> 0xE0, 0 -> 0 (the
// mask drops the bits each byte's shift carries into the next)
__device__ __forceinline__ uint32_t times32(uint32_t b) {
  return (b << 5) & 0xE0E0E0E0u;
}

}  // namespace ternary
