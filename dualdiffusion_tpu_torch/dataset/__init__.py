from .dataloader import DatasetConfig, DualDiffusionDataset
from .synthetic import write_latent_dataset
