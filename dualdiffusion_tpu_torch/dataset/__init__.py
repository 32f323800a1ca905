from .dataloader import DatasetConfig, DualDiffusionDataset
from .synthetic import write_audio_dataset, write_latent_dataset
