from robosuite_tpu_torch.controllers.composite.composite_controller import (  # noqa: F401
    CompositeControllerSpec,
    make_composite,
    register_composite_controller,
)
