from euler_tpu_torch.cli import main

main()
