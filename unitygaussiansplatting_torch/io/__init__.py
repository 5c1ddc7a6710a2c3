"""Asset pipeline: PLY/SPZ import, chunked quantized assets (byte-compatible
with the reference's), export, and rendering from their words on the device."""

from .asset import GaussianSplatAssetData, decode_asset, encode_asset, load_asset, save_asset
from .bridge import gaussians_to_input_splats, input_splats_to_gaussians
from .creator import create_asset
from .device_asset import DeviceAsset, decode_device, device_asset_from_asset, encode_device
from .formats import ColorFormat, QualityPreset, SHFormat, VectorFormat
from .ply import read_ply, write_ply
from .spz import read_spz, write_spz

__all__ = [
    "ColorFormat",
    "DeviceAsset",
    "GaussianSplatAssetData",
    "QualityPreset",
    "SHFormat",
    "VectorFormat",
    "create_asset",
    "decode_asset",
    "decode_device",
    "device_asset_from_asset",
    "encode_asset",
    "encode_device",
    "gaussians_to_input_splats",
    "input_splats_to_gaussians",
    "load_asset",
    "read_ply",
    "read_spz",
    "save_asset",
    "write_ply",
    "write_spz",
]
