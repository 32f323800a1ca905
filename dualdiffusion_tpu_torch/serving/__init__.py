from .model_server import ModelServer, launch, start_model_server
from .webui import run_app
