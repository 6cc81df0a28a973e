from massivedatans_tpu_torch.datagen.generators import (  # noqa: F401
    GENERATORS,
    gen_horns,
    gen_nothing,
    gen_simple,
    gen_simple_bright,
    gen_simple_faint,
    gen_agn,
    gen_realistic,
    save_dataset,
)
