from repro_torch.serving.admission import (ADMISSION, AdmissionPolicy,
                                           AdmissionView,
                                           KVHeadroomAdmission,
                                           SLODeadlineAdmission,
                                           StabilityAdmission)
from repro_torch.serving.control import (ControllerConfig, EwmaMean,
                                         StabilityController, WindowedRate,
                                         WindowedSum)
from repro_torch.serving.engine import (EngineStats, HarvestServingEngine,
                                        RequestRecord, SpecDecodeConfig)
from repro_torch.serving.scheduler import (SCHEDULERS, SLO_CLASSES,
                                           CompletelyFairScheduler,
                                           FCFSScheduler, Request)
from repro_torch.serving.server import (HarvestServer, RequestHandle,
                                        ServeRequest)
from repro_torch.serving.workload import (ARRIVALS, TenantSpec, Workload,
                                          bursty_arrivals, diurnal_arrivals,
                                          diurnal_arrivals_bulk,
                                          flood_arrivals, poisson_arrivals,
                                          ramp_arrivals, trace_arrivals)
