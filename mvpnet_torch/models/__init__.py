"""Networks of MVPNet3D: UNet-ResNet34, PN2SSG and the fusion model."""
from mvpnet_torch.models.build import build_model  # noqa: F401
from mvpnet_torch.models.fusion import FeatureAggregation, MVPNet3D  # noqa: F401
from mvpnet_torch.models.pointnet2 import PN2SSG  # noqa: F401
from mvpnet_torch.models.unet import UNetResNet34  # noqa: F401
