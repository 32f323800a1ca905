from .dataloader import DatasetConfig, DualDiffusionDataset, custom_collate
from .processor import DatasetProcessor, DatasetProcessorConfig, DatasetProcessStage, WorkQueue
from . import processes
from .synthetic import write_audio_dataset, write_latent_dataset
