"""quiver_tpu_torch.quant — the quantized feature store (encoded rows in
every tier, decoded on the card inside the gathers): the port of
``quiver_tpu/quant``.

- ``codecs``: the codec registry (``fp32``, ``bf16``, ``int8``) and the
  `Codec` contract;
- ``QuantizedFeature``: the tiered store of encoded rows over a `Feature`;
- ``lookup``: `gather_dequant` (K9a, resident tables),
  `quantized_tiered_lookup` (K9b, the pipeline's assembly),
  `sharded_dequant_gather` (K13a's pack of the encoded rows, a sum over the
  mesh's ici group, then K9c's decode) and `make_quantized_train_step`.
"""

from .codecs import CODECS, Bf16Codec, Codec, Int8Codec, QuantizedRows, get_codec, register_codec
from .feature import QuantizedFeature
from .lookup import (gather_dequant, make_quantized_train_step, quantized_tiered_lookup,
                     sharded_dequant_gather)

__all__ = [
    "CODECS", "Bf16Codec", "Codec", "Int8Codec", "QuantizedFeature", "QuantizedRows",
    "gather_dequant", "get_codec", "make_quantized_train_step", "quantized_tiered_lookup",
    "register_codec", "sharded_dequant_gather",
]
