"""repro_torch.wire: ciphertext serialization and bandwidth optimization,
byte-compatible with the JAX package's `repro.wire`.

format    versioned length-prefixed binary frames for every FL artifact
compress  seed-expanded ciphertexts, RNS limb dropping, plain quantization
stream    chunked uplink protocol + O(1)-in-clients server ingest
budget    per-round measured-bytes ledger

See DESIGN.md §6 and §9.
"""
from repro_torch.wire.budget import (BandwidthLedger, DOWNLINK, K_CIPHERTEXT,
                                     K_META, K_PLAIN, K_SEEDED_CT, UPLINK)
from repro_torch.wire.compress import (COMPACT, DERIVE_FOLD_CHUNK, LOSSLESS,
                                       SeededCiphertext, WirePolicy,
                                       dequantize_plain, limb_drop,
                                       quantize_plain, seed_compress)
from repro_torch.wire.format import (SUPPORTED_VERSIONS, VERSION, FrameReader,
                                     WireError, deserialize, iter_frames,
                                     serialize_ciphertext, serialize_keyset,
                                     serialize_partition,
                                     serialize_seeded_ciphertext,
                                     serialize_update)
from repro_torch.wire.stream import (StreamIngest, UpdateMeta,
                                     pack_update_frames, peek_update_meta)

__all__ = [
    "BandwidthLedger", "UPLINK", "DOWNLINK", "K_CIPHERTEXT", "K_SEEDED_CT",
    "K_PLAIN", "K_META", "WirePolicy", "LOSSLESS", "COMPACT",
    "VERSION", "SUPPORTED_VERSIONS", "DERIVE_FOLD_CHUNK",
    "SeededCiphertext", "seed_compress", "limb_drop", "quantize_plain",
    "dequantize_plain", "FrameReader", "WireError", "deserialize",
    "iter_frames", "serialize_ciphertext", "serialize_seeded_ciphertext",
    "serialize_update", "serialize_keyset", "serialize_partition",
    "StreamIngest", "UpdateMeta", "pack_update_frames", "peek_update_meta",
]
