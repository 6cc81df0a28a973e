from massivedatans_tpu_torch.cli import main

main()
