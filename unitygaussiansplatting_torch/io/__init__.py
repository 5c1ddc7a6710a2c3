"""Asset pipeline: chunked quantized assets (byte-compatible with the
reference's), and rendering from their words on the device."""

from .asset import GaussianSplatAssetData, decode_asset, encode_asset, load_asset, save_asset
from .bridge import gaussians_to_input_splats, input_splats_to_gaussians
from .device_asset import DeviceAsset, decode_device, device_asset_from_asset, encode_device
from .formats import ColorFormat, QualityPreset, SHFormat, VectorFormat

__all__ = [
    "ColorFormat",
    "DeviceAsset",
    "GaussianSplatAssetData",
    "QualityPreset",
    "SHFormat",
    "VectorFormat",
    "decode_asset",
    "decode_device",
    "device_asset_from_asset",
    "encode_asset",
    "encode_device",
    "gaussians_to_input_splats",
    "input_splats_to_gaussians",
    "load_asset",
    "save_asset",
]
