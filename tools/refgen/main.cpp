// refgen — golden-vector generator driving the REFERENCE implementation.
//
// Compiles selected translation units from /root/reference (srsRAN Project)
// and exercises them over deterministic cases, dumping inputs/outputs as raw
// little-endian .dat files (the reference's file_vector format,
// include/srsran/support/file_vector.h:63-81) plus a JSON manifest per suite.
//
// This framework's tests/vectors/ suite then asserts bit-exact (integer
// domains) or tolerance-bounded (float domains) parity against these.
//
// Usage: refgen <outdir-root> [suite ...]   (no suites = all)

#include "common.h"

#include "lib/phy/upper/channel_coding/crc_calculator_generic_impl.h"
#include "lib/phy/upper/channel_coding/crc_calculator_lut_impl.h"
#include "lib/phy/upper/channel_coding/ldpc/ldpc_decoder_generic.h"
#include "lib/phy/upper/channel_coding/ldpc/ldpc_encoder_generic.h"
#include "lib/phy/upper/channel_coding/ldpc/ldpc_rate_dematcher_impl.h"
#include "lib/phy/upper/channel_coding/ldpc/ldpc_rate_matcher_impl.h"
#include "lib/phy/upper/channel_coding/ldpc/ldpc_segmenter_tx_impl.h"
#include "lib/phy/upper/channel_modulation/demodulation_mapper_impl.h"
#include "lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.h"
#include "lib/phy/upper/sequence_generators/low_papr_sequence_generator_impl.h"
#include "lib/phy/upper/sequence_generators/pseudo_random_generator_impl.h"
#include "srsran/srsvec/bit.h"

#include <cmath>
#include <cstring>
#include <functional>
#include <map>

using namespace srsran;
using namespace refgen;

std::string g_root_outdir;

// Suites defined in gen_ran.cpp.
void gen_ran_tbs();
void gen_ran_mcs();
void gen_ran_beta();
void gen_ulsch_info();
void gen_dlsch_info();
void gen_polar();
void gen_short_block();
void gen_pdcch_candidates();
void gen_csi_report();

// Suites defined in gen_phy.cpp.
void gen_dft_suite();
void gen_ofdm_modulator_suite();
void gen_ofdm_demodulator_suite();
void gen_equalizer_suite();
void gen_prach_generator_suite();
void gen_estimator_suite();
void gen_prach_detector_suite();
void gen_dmrs_suites();
void gen_pdsch_processor_suite();
void gen_ulsch_demux_suite();
void gen_pusch_demodulator_suite();
void gen_pusch_processor_suite();
void gen_pucch_format0_suite();
void gen_pucch_format1_suite();
void gen_pucch_format2_suite();
void gen_pucch_format34_suite();
void gen_pdcch_processor_suite();
void gen_ssb_processor_suite();
void gen_csi_rs_generator_suite();
void gen_prs_generator_suite();
void gen_srs_estimator_suite();
void gen_prach_demodulator_suite();
void gen_harq_retx_suite();
void gen_bler_parity_suite();

// Suites defined in gen_tail.cpp.
void gen_uci_decoder_suite();
void gen_transform_precoder_suite();
void gen_dmrs_pusch_suite();

namespace {

void start_suite(const std::string& name) {
  set_outdir(g_root_outdir + "/" + name);
}

// ------------------------------------------------------------------ crc ----

void gen_crc() {
  start_suite("crc");
  manifest m("manifest.json");
  auto rng = make_rng(0xC4C1);
  const std::pair<crc_generator_poly, const char*> polys[] = {
      {crc_generator_poly::CRC24A, "24A"}, {crc_generator_poly::CRC24B, "24B"},
      {crc_generator_poly::CRC24C, "24C"}, {crc_generator_poly::CRC16, "16"},
      {crc_generator_poly::CRC11, "11"},   {crc_generator_poly::CRC6, "6"},
  };
  const unsigned byte_lens[] = {1, 2, 3, 7, 16, 57, 312, 1023};
  const unsigned bit_lens[]  = {1, 5, 11, 39, 100, 1021, 8191};
  int idx = 0;
  for (auto [poly, pname] : polys) {
    // LUT impl has no CRC6 table; use the generic bitwise impl there.
    crc_calculator_generic_impl crc(poly);
    for (unsigned len : byte_lens) {
      auto msg = random_bytes(rng, len);
      unsigned checksum = crc.calculate_byte(msg);
      std::string f = "msg" + std::to_string(idx) + ".dat";
      write_dat(f, msg);
      m.begin_case();
      m.field("poly", std::string(pname));
      m.field("mode", std::string("byte"));
      m.field("len", (long long)len);
      m.field("msg", f);
      m.field("crc", (long long)checksum);
      m.end_case();
      ++idx;
    }
    for (unsigned len : bit_lens) {
      auto bits = random_bits(rng, len);
      unsigned checksum = crc.calculate_bit(bits);
      std::string f = "msg" + std::to_string(idx) + ".dat";
      write_dat(f, bits);
      m.begin_case();
      m.field("poly", std::string(pname));
      m.field("mode", std::string("bit"));
      m.field("len", (long long)len);
      m.field("msg", f);
      m.field("crc", (long long)checksum);
      m.end_case();
      ++idx;
    }
  }
  m.flush();
}

// ------------------------------------------------------------ scrambler ----

void gen_scrambler() {
  start_suite("scrambler");
  manifest m("manifest.json");
  auto rng = make_rng(0x5C4A);
  std::uniform_int_distribution<uint32_t> cinit_d(0, (1u << 31) - 1);
  const unsigned offsets[] = {0, 1, 7, 31, 63, 100, 1600, 25600, 65536};
  pseudo_random_generator_impl gen;
  int idx = 0;
  for (int c = 0; c < 8; ++c) {
    uint32_t cinit = (c == 0) ? 0 : cinit_d(rng);
    for (unsigned off : offsets) {
      const unsigned L = 1536;
      gen.init(cinit);
      if (off) gen.advance(off);
      // Sequence bits: XOR against a zero buffer.
      dynamic_bit_buffer zeros(L), out(L);
      std::memset(zeros.get_buffer().data(), 0, zeros.get_buffer().size());
      gen.apply_xor(out, zeros);
      std::vector<uint8_t> seq(L);
      srsvec::bit_unpack(seq, out);
      std::string f = "seq" + std::to_string(idx) + ".dat";
      write_dat(f, seq);
      m.begin_case();
      m.field("c_init", (long long)cinit);
      m.field("offset", (long long)off);
      m.field("len", (long long)L);
      m.field("seq", f);
      m.end_case();
      ++idx;
    }
  }
  m.flush();
}

// --------------------------------------------------------- ldpc encoder ----

void gen_ldpc_encoder() {
  start_suite("ldpc_encoder");
  manifest m("manifest.json");
  auto rng = make_rng(0x1D9C);
  ldpc_encoder_generic enc;
  int idx = 0;
  for (auto bg : {ldpc_base_graph_type::BG1, ldpc_base_graph_type::BG2}) {
    unsigned bg_K = (bg == ldpc_base_graph_type::BG1) ? 22 : 10;
    unsigned bg_N_short = (bg == ldpc_base_graph_type::BG1) ? 66 : 50;
    for (auto ls : ldpc::all_lifting_sizes) {
      unsigned Z = (unsigned)ls;
      unsigned K = bg_K * Z;
      auto msg_bits = random_bits(rng, K);
      dynamic_bit_buffer msg(K);
      srsvec::bit_pack(msg, msg_bits);
      ldpc_encoder::configuration cfg;
      cfg.base_graph = bg;
      cfg.lifting_size = ls;
      const ldpc_encoder_buffer& buf = enc.encode(msg, cfg);
      unsigned N = bg_N_short * Z;
      std::vector<uint8_t> cw(N);
      buf.write_codeblock(cw, 0);
      std::string fi = "in" + std::to_string(idx) + ".dat";
      std::string fo = "out" + std::to_string(idx) + ".dat";
      write_dat(fi, msg_bits);
      write_dat(fo, cw);
      m.begin_case();
      m.field("bg", (long long)(bg == ldpc_base_graph_type::BG1 ? 1 : 2));
      m.field("ls", (long long)Z);
      m.field("input", fi);
      m.field("output", fo);
      m.field("out_len", (long long)N);
      m.end_case();
      ++idx;
    }
  }
  m.flush();
}

// ----------------------------------------------------- ldpc rate matcher ----

struct rm_case {
  ldpc_base_graph_type bg;
  ldpc::lifting_size_t ls;
  unsigned rv;
  modulation_scheme mod;
  double rate;     // E = K / rate rounded to Qm multiple
  unsigned nref;   // 0 = unlimited
  unsigned filler; // filler bits in codeblock
};

void gen_ldpc_rate_matcher() {
  start_suite("ldpc_rate_matcher");
  manifest m("manifest.json");
  auto rng = make_rng(0x4A7E);
  ldpc_encoder_generic enc;
  ldpc_rate_matcher_impl rm;
  std::vector<rm_case> cases;
  for (auto bg : {ldpc_base_graph_type::BG1, ldpc_base_graph_type::BG2}) {
    for (auto ls : {ldpc::LS2, ldpc::LS6, ldpc::LS36, ldpc::LS52, ldpc::LS144, ldpc::LS208, ldpc::LS384}) {
      for (unsigned rv : {0u, 1u, 2u, 3u}) {
        for (auto mod : {modulation_scheme::QPSK, modulation_scheme::QAM16, modulation_scheme::QAM64,
                         modulation_scheme::QAM256}) {
          cases.push_back({bg, ls, rv, mod, 0.5, 0, 0});
        }
        cases.push_back({bg, ls, rv, modulation_scheme::BPSK, 0.33, 0, 0});
        cases.push_back({bg, ls, rv, modulation_scheme::QAM64, 0.9, 0, 0});
      }
      // limited-buffer + filler variants, rv1 picks k0 sensitivity
      cases.push_back({bg, ls, 1, modulation_scheme::QAM16, 0.5, 1, 0});
      cases.push_back({bg, ls, 2, modulation_scheme::QAM16, 0.6, 1, 17});
      cases.push_back({bg, ls, 0, modulation_scheme::QAM256, 0.45, 0, 8});
    }
  }
  int idx = 0;
  for (const auto& c : cases) {
    unsigned Z = (unsigned)c.ls;
    unsigned bg_K = (c.bg == ldpc_base_graph_type::BG1) ? 22 : 10;
    unsigned bg_N_short = (c.bg == ldpc_base_graph_type::BG1) ? 66 : 50;
    unsigned K = bg_K * Z;
    unsigned N = bg_N_short * Z;
    if (c.filler >= K / 2) continue;
    unsigned Qm = (unsigned)c.mod;
    unsigned E = (unsigned)std::lround(K / c.rate);
    E = (E / Qm) * Qm;
    if (E == 0 || E > (N + 2 * Z)) E = (N / Qm) * Qm;
    unsigned nref = c.nref ? (N * 2) / 3 : 0;
    auto msg_bits = random_bits(rng, K);
    for (unsigned i = K - c.filler; i < K; ++i) msg_bits[i] = 0;
    dynamic_bit_buffer msg(K);
    srsvec::bit_pack(msg, msg_bits);
    ldpc_encoder::configuration ecfg;
    ecfg.base_graph = c.bg;
    ecfg.lifting_size = c.ls;
    ecfg.Nref = nref;
    const ldpc_encoder_buffer& buf = enc.encode(msg, ecfg);
    codeblock_metadata rmcfg = {};
    rmcfg.tb_common.base_graph = c.bg;
    rmcfg.tb_common.lifting_size = c.ls;
    rmcfg.tb_common.rv = c.rv;
    rmcfg.tb_common.mod = c.mod;
    rmcfg.tb_common.Nref = nref;
    rmcfg.cb_specific.nof_filler_bits = c.filler;
    dynamic_bit_buffer out(E);
    rm.rate_match(out, buf, rmcfg);
    std::vector<uint8_t> out_bits(E);
    srsvec::bit_unpack(out_bits, out);
    std::string fi = "in" + std::to_string(idx) + ".dat";
    std::string fo = "out" + std::to_string(idx) + ".dat";
    write_dat(fi, msg_bits);
    write_dat(fo, out_bits);
    m.begin_case();
    m.field("bg", (long long)(c.bg == ldpc_base_graph_type::BG1 ? 1 : 2));
    m.field("ls", (long long)Z);
    m.field("rv", (long long)c.rv);
    m.field("qm", (long long)Qm);
    m.field("e", (long long)E);
    m.field("nref", (long long)nref);
    m.field("filler", (long long)c.filler);
    m.field("input", fi);
    m.field("output", fo);
    m.end_case();
    ++idx;
  }
  m.flush();
}

// --------------------------------------------------- ldpc rate dematcher ----

void gen_ldpc_rate_dematcher() {
  start_suite("ldpc_rate_dematcher");
  manifest m("manifest.json");
  auto rng = make_rng(0xDE3A);
  ldpc_rate_dematcher_impl rdm;
  std::uniform_int_distribution<int> llr_d(-60, 60);
  int idx = 0;
  for (auto bg : {ldpc_base_graph_type::BG1, ldpc_base_graph_type::BG2}) {
    for (auto ls : {ldpc::LS2, ldpc::LS36, ldpc::LS144, ldpc::LS384}) {
      for (unsigned rv : {0u, 1u, 2u, 3u}) {
        for (unsigned filler : {0u, 20u}) {
          unsigned Z = (unsigned)ls;
          unsigned bg_K = (bg == ldpc_base_graph_type::BG1) ? 22 : 10;
          unsigned bg_N_short = (bg == ldpc_base_graph_type::BG1) ? 66 : 50;
          unsigned K = bg_K * Z;
          unsigned N = bg_N_short * Z;
          if (filler >= K / 2) continue;
          unsigned Qm = 4;
          unsigned E = ((K * 2) / Qm) * Qm;
          std::vector<log_likelihood_ratio> in(E), in2(E);
          for (auto& v : in) v = llr_d(rng);
          for (auto& v : in2) v = llr_d(rng);
          std::vector<log_likelihood_ratio> out(N);
          codeblock_metadata cfg = {};
          cfg.tb_common.base_graph = bg;
          cfg.tb_common.lifting_size = ls;
          cfg.tb_common.rv = rv;
          cfg.tb_common.mod = modulation_scheme::QAM16;
          cfg.tb_common.Nref = 0;
          cfg.cb_specific.nof_filler_bits = filler;
          rdm.rate_dematch(out, in, /*new_data=*/true, cfg);
          std::string f1 = "in" + std::to_string(idx) + "_tx0.dat";
          write_dat(f1, reinterpret_cast<const int8_t*>(in.data()), in.size());
          std::string fo1 = "out" + std::to_string(idx) + "_tx0.dat";
          write_dat(fo1, reinterpret_cast<const int8_t*>(out.data()), out.size());
          // HARQ retransmission with rv2 combined on top.
          codeblock_metadata cfg2 = cfg;
          cfg2.tb_common.rv = (rv + 2) % 4;
          rdm.rate_dematch(out, in2, /*new_data=*/false, cfg2);
          std::string f2 = "in" + std::to_string(idx) + "_tx1.dat";
          write_dat(f2, reinterpret_cast<const int8_t*>(in2.data()), in2.size());
          std::string fo2 = "out" + std::to_string(idx) + "_tx1.dat";
          write_dat(fo2, reinterpret_cast<const int8_t*>(out.data()), out.size());
          m.begin_case();
          m.field("bg", (long long)(bg == ldpc_base_graph_type::BG1 ? 1 : 2));
          m.field("ls", (long long)Z);
          m.field("rv0", (long long)rv);
          m.field("rv1", (long long)((rv + 2) % 4));
          m.field("qm", (long long)Qm);
          m.field("e", (long long)E);
          m.field("filler", (long long)filler);
          m.field("n", (long long)N);
          m.field("in0", f1);
          m.field("out0", fo1);
          m.field("in1", f2);
          m.field("out1", fo2);
          m.end_case();
          ++idx;
        }
      }
    }
  }
  m.flush();
}

// -------------------------------------------------------- ldpc segmenter ----

void gen_ldpc_segmenter() {
  start_suite("ldpc_segmenter");
  manifest m("manifest.json");
  auto rng = make_rng(0x5E97);
  ldpc_segmenter_tx_impl::sch_crc crcs{
      std::make_unique<crc_calculator_lut_impl>(crc_generator_poly::CRC16),
      std::make_unique<crc_calculator_lut_impl>(crc_generator_poly::CRC24A),
      std::make_unique<crc_calculator_lut_impl>(crc_generator_poly::CRC24B)};
  ldpc_segmenter_tx_impl seg(crcs);
  struct seg_case { unsigned tbs_bytes; ldpc_base_graph_type bg; modulation_scheme mod; unsigned layers; unsigned syms; };
  std::vector<seg_case> cases = {
      {3, ldpc_base_graph_type::BG2, modulation_scheme::QPSK, 1, 100},
      {24, ldpc_base_graph_type::BG2, modulation_scheme::QPSK, 1, 200},
      {477, ldpc_base_graph_type::BG1, modulation_scheme::QAM16, 1, 1600},
      {478, ldpc_base_graph_type::BG2, modulation_scheme::QAM16, 1, 1600},
      {479, ldpc_base_graph_type::BG1, modulation_scheme::QAM16, 1, 1600},
      {1056, ldpc_base_graph_type::BG1, modulation_scheme::QAM64, 2, 2400},
      {1057, ldpc_base_graph_type::BG2, modulation_scheme::QAM64, 2, 2400},
      {12345, ldpc_base_graph_type::BG1, modulation_scheme::QAM256, 4, 14000},
      {98765, ldpc_base_graph_type::BG1, modulation_scheme::QAM256, 4, 60000},
  };
  int idx = 0;
  for (const auto& c : cases) {
    auto tb = random_bytes(rng, c.tbs_bytes);
    segmenter_config cfg;
    cfg.base_graph = c.bg;
    cfg.rv = 0;
    cfg.mod = c.mod;
    cfg.Nref = 0;
    cfg.nof_layers = c.layers;
    cfg.nof_ch_symbols = c.syms;
    const ldpc_segmenter_buffer& buf = seg.new_transmission(tb, cfg);
    unsigned nof_cb = buf.get_nof_codeblocks();
    unsigned seg_len = buf.get_segment_length().value();
    std::string ftb = "tb" + std::to_string(idx) + ".dat";
    write_dat(ftb, tb);
    for (unsigned cb = 0; cb < nof_cb; ++cb) {
      dynamic_bit_buffer cb_bits(seg_len);
      buf.read_codeblock(cb_bits, tb, cb);
      std::vector<uint8_t> unpacked(seg_len);
      srsvec::bit_unpack(unpacked, cb_bits);
      std::string fcb = "cb" + std::to_string(idx) + "_" + std::to_string(cb) + ".dat";
      write_dat(fcb, unpacked);
      auto md = buf.get_cb_metadata(cb);
      m.begin_case();
      m.field("tb", ftb);
      m.field("tbs_bytes", (long long)c.tbs_bytes);
      m.field("bg", (long long)(c.bg == ldpc_base_graph_type::BG1 ? 1 : 2));
      m.field("qm", (long long)(unsigned)c.mod);
      m.field("layers", (long long)c.layers);
      m.field("ch_symbols", (long long)c.syms);
      m.field("nof_cb", (long long)nof_cb);
      m.field("cb_index", (long long)cb);
      m.field("cb_data", fcb);
      m.field("seg_len", (long long)seg_len);
      m.field("ls", (long long)(unsigned)md.tb_common.lifting_size);
      m.field("rm_length", (long long)md.cb_specific.rm_length);
      m.field("filler", (long long)md.cb_specific.nof_filler_bits);
      m.field("cw_offset", (long long)md.cb_specific.cw_offset);
      m.field("crc_bits", (long long)md.cb_specific.nof_crc_bits);
      m.end_case();
    }
    ++idx;
  }
  m.flush();
}

// ---------------------------------------------------------- ldpc decoder ----

void gen_ldpc_decoder() {
  start_suite("ldpc_decoder");
  manifest m("manifest.json");
  auto rng = make_rng(0xD0DE);
  ldpc_encoder_generic enc;
  ldpc_decoder_generic dec(/*force_decoding=*/false);
  std::normal_distribution<float> noise_d(0.f, 1.f);
  int idx = 0;
  for (auto bg : {ldpc_base_graph_type::BG1, ldpc_base_graph_type::BG2}) {
    for (auto ls : {ldpc::LS2, ldpc::LS36, ldpc::LS144, ldpc::LS384}) {
      for (float snr_db : {2.f, 6.f}) {
        for (unsigned iters : {6u, 10u}) {
          unsigned Z = (unsigned)ls;
          unsigned bg_K = (bg == ldpc_base_graph_type::BG1) ? 22 : 10;
          unsigned bg_N_short = (bg == ldpc_base_graph_type::BG1) ? 66 : 50;
          unsigned K = bg_K * Z;
          unsigned N = bg_N_short * Z;
          auto msg_bits = random_bits(rng, K);
          dynamic_bit_buffer msg(K);
          srsvec::bit_pack(msg, msg_bits);
          ldpc_encoder::configuration ecfg;
          ecfg.base_graph = bg;
          ecfg.lifting_size = ls;
          const ldpc_encoder_buffer& buf = enc.encode(msg, ecfg);
          std::vector<uint8_t> cw(N);
          buf.write_codeblock(cw, 0);
          // BPSK over AWGN -> LLR quantized to int8 (scale 8/sigma^2-ish).
          float sigma = std::pow(10.f, -snr_db / 20.f);
          std::vector<log_likelihood_ratio> llrs(N);
          for (unsigned i = 0; i < N; ++i) {
            float x = (cw[i] ? -1.f : 1.f) + sigma * noise_d(rng);
            float l = 2.f * x / (sigma * sigma);
            int q = (int)std::lround(l * 4.f);
            llrs[i] = std::max(-127, std::min(127, q));
          }
          dynamic_bit_buffer out(K);
          ldpc_decoder::configuration dcfg;
          dcfg.base_graph = bg;
          dcfg.lifting_size = ls;
          dcfg.nof_filler_bits = 0;
          dcfg.nof_crc_bits = 16; // required 16/24 by the decoder; unused without a crc calculator

          dcfg.max_iterations = iters;
          dec.decode(out, llrs, nullptr, dcfg);
          std::vector<uint8_t> out_bits(K);
          srsvec::bit_unpack(out_bits, out);
          std::string fl = "llr" + std::to_string(idx) + ".dat";
          write_dat(fl, reinterpret_cast<const int8_t*>(llrs.data()), llrs.size());
          std::string fo = "out" + std::to_string(idx) + ".dat";
          write_dat(fo, out_bits);
          std::string fm = "msg" + std::to_string(idx) + ".dat";
          write_dat(fm, msg_bits);
          m.begin_case();
          m.field("bg", (long long)(bg == ldpc_base_graph_type::BG1 ? 1 : 2));
          m.field("ls", (long long)Z);
          m.field("snr_db", (double)snr_db);
          m.field("max_iter", (long long)iters);
          m.field("llrs", fl);
          m.field("output", fo);
          m.field("message", fm);
          m.end_case();
          ++idx;
        }
      }
    }
  }
  m.flush();
}

// ----------------------------------------------------------- mod mapper ----

const std::pair<modulation_scheme, const char*> kMods[] = {
    {modulation_scheme::PI_2_BPSK, "pi2bpsk"}, {modulation_scheme::BPSK, "bpsk"},
    {modulation_scheme::QPSK, "qpsk"},         {modulation_scheme::QAM16, "qam16"},
    {modulation_scheme::QAM64, "qam64"},       {modulation_scheme::QAM256, "qam256"},
};

void gen_mod_mapper() {
  start_suite("mod_mapper");
  manifest m("manifest.json");
  auto rng = make_rng(0x3071);
  modulation_mapper_lut_impl mapper;
  int idx = 0;
  for (auto [mod, name] : kMods) {
    unsigned qm = std::max(1u, (unsigned)mod);
    for (unsigned nsym : {16u, 255u, 3072u}) {
      unsigned nbits = nsym * qm;
      auto bits = random_bits(rng, nbits);
      dynamic_bit_buffer packed(nbits);
      srsvec::bit_pack(packed, bits);
      std::vector<cf_t> syms(nsym);
      mapper.modulate(syms, packed, mod);
      std::string fi = "bits" + std::to_string(idx) + ".dat";
      write_dat(fi, bits);
      std::string fo = "syms" + std::to_string(idx) + ".dat";
      write_dat(fo, reinterpret_cast<const float*>(syms.data()), 2 * nsym);
      m.begin_case();
      m.field("mod", std::string(name));
      m.field("qm", (long long)qm);
      m.field("nsym", (long long)nsym);
      m.field("bits", fi);
      m.field("symbols", fo);
      m.end_case();
      ++idx;
    }
  }
  m.flush();
}

// --------------------------------------------------------- demod mapper ----

void gen_demod_mapper() {
  start_suite("demod_mapper");
  manifest m("manifest.json");
  auto rng = make_rng(0xDE40);
  modulation_mapper_lut_impl mapper;
  demodulation_mapper_impl demapper;
  std::normal_distribution<float> noise_d(0.f, 1.f);
  std::uniform_real_distribution<float> nv_d(0.05f, 2.f);
  int idx = 0;
  for (auto [mod, name] : kMods) {
    unsigned qm = std::max(1u, (unsigned)mod);
    for (unsigned nsym : {64u, 2048u}) {
      unsigned nbits = nsym * qm;
      auto bits = random_bits(rng, nbits);
      dynamic_bit_buffer packed(nbits);
      srsvec::bit_pack(packed, bits);
      std::vector<cf_t> syms(nsym);
      mapper.modulate(syms, packed, mod);
      std::vector<float> noise_vars(nsym);
      for (unsigned i = 0; i < nsym; ++i) {
        float nv = nv_d(rng);
        noise_vars[i] = nv;
        syms[i] += std::sqrt(nv) * cf_t(noise_d(rng), noise_d(rng)) * 0.7071068f;
      }
      std::vector<log_likelihood_ratio> llrs(nbits);
      demapper.demodulate_soft(llrs, syms, noise_vars, mod);
      std::string fs = "syms" + std::to_string(idx) + ".dat";
      write_dat(fs, reinterpret_cast<const float*>(syms.data()), 2 * nsym);
      std::string fn = "nvar" + std::to_string(idx) + ".dat";
      write_dat(fn, noise_vars);
      std::string fo = "llrs" + std::to_string(idx) + ".dat";
      write_dat(fo, reinterpret_cast<const int8_t*>(llrs.data()), nbits);
      m.begin_case();
      m.field("mod", std::string(name));
      m.field("qm", (long long)qm);
      m.field("nsym", (long long)nsym);
      m.field("symbols", fs);
      m.field("noise_vars", fn);
      m.field("llrs", fo);
      m.end_case();
      ++idx;
    }
  }
  m.flush();
}

// ------------------------------------------------------------ low-PAPR ----

void gen_low_papr() {
  start_suite("low_papr");
  manifest m("manifest.json");
  low_papr_sequence_generator_impl gen;
  int idx = 0;
  for (unsigned m_rb : {1u, 2u, 3u, 4u, 6u, 8u, 16u, 32u}) {
    unsigned M = m_rb * 12;
    for (unsigned u : {0u, 7u, 17u, 29u}) {
      for (unsigned v = 0; v < ((m_rb >= 6) ? 2u : 1u); ++v) {
        for (unsigned alpha_num : {0u, 3u}) {
          std::vector<cf_t> seq(M);
          gen.generate(seq, u, v, alpha_num, 12);
          std::string fo = "seq" + std::to_string(idx) + ".dat";
          write_dat(fo, reinterpret_cast<const float*>(seq.data()), 2 * M);
          m.begin_case();
          m.field("m", (long long)M);
          m.field("u", (long long)u);
          m.field("v", (long long)v);
          m.field("alpha_num", (long long)alpha_num);
          m.field("alpha_den", (long long)12);
          m.field("seq", fo);
          m.end_case();
          ++idx;
        }
      }
    }
  }
  m.flush();
}

} // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    ::fprintf(stderr, "usage: %s <outdir> [suite ...]\n", argv[0]);
    return 1;
  }
  g_root_outdir = argv[1];
  ::mkdir(g_root_outdir.c_str(), 0755);
  std::map<std::string, std::function<void()>> suites = {
      {"crc", gen_crc},
      {"scrambler", gen_scrambler},
      {"ldpc_encoder", gen_ldpc_encoder},
      {"ldpc_rate_matcher", gen_ldpc_rate_matcher},
      {"ldpc_rate_dematcher", gen_ldpc_rate_dematcher},
      {"ldpc_segmenter", gen_ldpc_segmenter},
      {"ldpc_decoder", gen_ldpc_decoder},
      {"mod_mapper", gen_mod_mapper},
      {"demod_mapper", gen_demod_mapper},
      {"low_papr", gen_low_papr},
      {"ran_tbs", gen_ran_tbs},
      {"ran_mcs", gen_ran_mcs},
      {"ran_beta", gen_ran_beta},
      {"ulsch_info", gen_ulsch_info},
      {"dlsch_info", gen_dlsch_info},
      {"polar", gen_polar},
      {"short_block", gen_short_block},
      {"pdcch_candidates", gen_pdcch_candidates},
      {"csi_report", gen_csi_report},
      {"dft", gen_dft_suite},
      {"ofdm_modulator", gen_ofdm_modulator_suite},
      {"ofdm_demodulator", gen_ofdm_demodulator_suite},
      {"equalizer", gen_equalizer_suite},
      {"prach_generator", gen_prach_generator_suite},
      {"estimator", gen_estimator_suite},
      {"prach_detector", gen_prach_detector_suite},
      {"dmrs", gen_dmrs_suites},
      {"pdsch_processor", gen_pdsch_processor_suite},
      {"ulsch_demux", gen_ulsch_demux_suite},
      {"pusch_demodulator", gen_pusch_demodulator_suite},
      {"pusch_processor_rx", gen_pusch_processor_suite},
      {"pucch_format0", gen_pucch_format0_suite},
      {"pucch_format1", gen_pucch_format1_suite},
      {"pucch_format2", gen_pucch_format2_suite},
      {"pucch_format34", gen_pucch_format34_suite},
      {"pdcch_processor", gen_pdcch_processor_suite},
      {"ssb_processor", gen_ssb_processor_suite},
      {"csi_rs_generator", gen_csi_rs_generator_suite},
      {"prs_generator", gen_prs_generator_suite},
      {"srs_estimator", gen_srs_estimator_suite},
      {"prach_demodulator", gen_prach_demodulator_suite},
      {"harq_retx", gen_harq_retx_suite},
      {"bler_parity", gen_bler_parity_suite},
      {"uci_decoder", gen_uci_decoder_suite},
      {"transform_precoder", gen_transform_precoder_suite},
      {"dmrs_pusch", gen_dmrs_pusch_suite},
  };
  if (argc == 2) {
    for (auto& [name, fn] : suites) fn();
    return 0;
  }
  for (int i = 2; i < argc; ++i) {
    auto it = suites.find(argv[i]);
    if (it == suites.end()) {
      ::fprintf(stderr, "unknown suite: %s\n", argv[i]);
      return 1;
    }
    it->second();
  }
  return 0;
}
