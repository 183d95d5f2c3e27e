"""GAN compositional-augmentation models (ICCV 2021 stack)."""

from sgg_torch.models.gan.crn import RefinementNetwork  # noqa: F401
from sgg_torch.models.gan.discriminators import (  # noqa: F401
    CondPatchDiscriminator, GlobalDiscriminator, SNConv, avg_pool_ceil,
    conditioned_features,
)
from sgg_torch.models.gan.gan import (  # noqa: F401
    GANModel, Generator, add_dummy_nodes, init_gan_weights,
)
from sgg_torch.models.gan.graphconv import (  # noqa: F401
    GraphTripleConv, GraphTripleConvNet, MaskedBatchNorm,
)
from sgg_torch.models.gan.layout import (  # noqa: F401
    boxes_to_layout, masks_to_layout,
)
