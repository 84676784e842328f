from .unet import UNetConfig, UNetModel, build_plan, unet_config_from_yaml  # noqa: F401
