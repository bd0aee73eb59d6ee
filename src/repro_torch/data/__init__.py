from repro_torch.data.pipeline import (DataConfig, TrainDataset, batch_for_step,
                                 TraceConfig, ETC, SYS, generate_trace)
from repro_torch.data.workloads import (WorkloadTrace, YCSBConfig, MLTraceConfig,
                                  MixedTenantConfig, YCSB_MIXES, ycsb_trace,
                                  ml_trace, mixed_tenant_traces,
                                  interleave_tenants, tenant_lifetimes)
