from repro_torch.serve.engine import ValetServeEngine, Request, EngineStats
