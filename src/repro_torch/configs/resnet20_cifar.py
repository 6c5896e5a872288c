"""ResNet-20 on CIFAR, the paper's own evaluation network (Table I).

CONFIG runs the paper operating point through the CIM macro model;
SMOKE is a narrow fp-mode variant. The records equal the JAX package's
``repro.configs.resnet20_cifar`` field for field. (``configs.resnet``'s
``RESNET_CFG`` is another record: the committed checkpoint's network.)
"""

from repro_torch.configs.base import CIMPolicy
from repro_torch.core.params import CIMConfig
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(
    n_classes=10,
    cim=CIMPolicy(
        mode="cim",
        cim=CIMConfig(rows_active=8, cutoff=0.5, adc_bits=4),
        act_symmetric=True,
        apply_to_logits=False,
    ),
)

SMOKE = ResNetConfig(
    n_classes=10,
    widths=(8, 16, 16),
    blocks_per_stage=1,
)
